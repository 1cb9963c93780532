"""The plain reference against the port's CPU path at tiny sizes."""

import numpy as np
import pytest
import torch

from portbench import surface, weights
from portbench.reference import gat_grid8 as ref
from portbench.tests.test_pb_contract import BENCH
from portbench import harness

CFG = harness.Cell("survey-f32", BENCH).config


def _tiles(seed, n=2, size=48):
    d = surface.synthetic_survey(size * n, size, seed, "cpu")
    d = d.reshape(n, size, size)
    return d, np.isfinite(d)


def test_features_and_graph_match_the_port():
    from bathymetric_gnn_tpu_torch.data.graph_build import build_grid_inputs

    d, v = _tiles(3)
    dt, vt = torch.from_numpy(np.nan_to_num(d)), torch.from_numpy(v)
    want = build_grid_inputs(dt, vt)
    got = ref.grid_graph(dt, vt)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.to(w.dtype), w, rtol=1e-5, atol=1e-4)


def test_survey_output_matches_the_port():
    from bathymetric_gnn_tpu_torch.inference.pipeline import \
        BathymetricPipeline

    d, v = _tiles(5)
    sd = weights.with_batch_statistics(
        weights.seeded_state_dict(CFG, 11, "cpu"), CFG,
        torch.from_numpy(np.nan_to_num(d[:1])), torch.from_numpy(v[:1]))
    pipe = BathymetricPipeline(device="cpu")
    pipe.use_state_dict(sd)
    want = pipe.forward_tiles(np.nan_to_num(d), v, None, (1.0, 1.0))
    got = ref.survey_tiles(sd, CFG, torch.from_numpy(np.nan_to_num(d)),
                           torch.from_numpy(v))
    vm = torch.from_numpy(v)
    assert (got[0][vm] != want[0][vm]).float().mean() < 1e-3
    assert (got[1][vm].float() - want[1][vm].float()).abs().max() < 2e-3
    # the outputs are not degenerate: classes and confidences vary
    assert want[1][vm].float().std() > 1e-2
    assert len(want[0][vm].unique()) == 3


@pytest.mark.parametrize("n", [2])
def test_philox_matches_known_answers(n):
    """Random123's known answers of Philox4x32-10 through the keep draw's
    arithmetic: counter 0, key 0 gives 0x6627e8d5 first."""
    # 0x6627e8d5 = 1714939093: kept at keep 0.7 (threshold 0.3 x 2^32 =
    # 1288490189), dropped at keep 0.5 (threshold 2^31)
    assert ref.philox_keep(0, (1,), 0.7, "cpu").item() == pytest.approx(
        1 / 0.7)
    assert ref.philox_keep(0, (1,), 0.5, "cpu").item() == 0.0
    m = ref.philox_keep(12345, (n, 9, 4, 8, 8), 0.9, "cpu")
    share = (m > 0).float().mean().item()
    assert abs(share - 0.9) < 0.03


@pytest.mark.parametrize("cell", ["grid-train-f32", "coo-train-f32"])
def test_training_reference_draws_the_programs_dropout(cell):
    """The reference follows the program's steps only with the same
    dropout draws: from another seed's generator it reads far off."""
    from portbench import compare
    from portbench.tests.cpu_cells import TINY

    c = harness.Cell(cell, BENCH)
    drv = c.driver()
    s = drv.setup(c, 31, "cpu", harness.Spans(), TINY[cell])
    drv.release(s)
    prog = {"losses": s.losses, "grads": s.first_grads, "change": s.change}
    limits = TINY[cell]["limits"]
    assert compare.passed(compare.train_readings(prog, drv._reference(
        s, "float32"), limits))
    s.seed += 1
    assert not compare.passed(compare.train_readings(prog, drv._reference(
        s, "float32"), limits))
