"""PyTorch port vs JAX: the process mesh, the differentiable collectives and
sync-BN (``bathymetric_gnn_tpu_torch/parallel/mesh.py``,
``collectives.py``, ``MaskedBatchNorm``'s ``group``).

One gloo world of 2 processes (``torch_parallel_workers``) runs every
case; the test process holds its results against:

- ``initialize_distributed``: a no-op with one process (in this process:
  no process group starts), idempotent in a world of 2, with the JAX
  function's keys; without ``device="cpu"`` it asks for NCCL and raises
  where there is no card, never falling back to gloo;
- ``make_host_mesh``: the (data, graph) layout, graph minor, and its
  refusals of a graph size the world does not divide and of one that
  spans nodes unevenly;
- ``shard_batch_pytree`` / ``host_local_batch_to_global``: each rank's
  slice (data split in rank order; rows split over ``graph``);
- ``all_reduce_sum``: the sum, and a backward that is the sum of every
  rank's cotangent (psum's transpose);
- ``halo_rows_split`` / ``exchange_halo_rows``: the rows each rank gets
  (zeros at the border), and the gradient of each rank's sum over what
  it received landing on the sender's boundary rows, equal to autograd
  of the same sums on the concatenated rows;
- a bf16 ``MaskedBatchNorm`` in training mode with a group: the f32
  autograd path (``_BnLowp`` never called; f32 out, as JAX's sharded
  path), its outputs, running statistics and input gradient against the
  JAX module's under ``shard_map`` over 2 devices (rtol 1e-5), and the
  moments against the unsharded ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bathymetric_gnn_tpu.models.layers import MaskedBatchNorm as JaxBN

from torch_parallel_workers import run_world

N, F = 10, 4


def _bn_inputs():
    rg = np.random.default_rng(0)
    x = rg.normal(1.0, 2.0, size=(2, N, F)).astype(np.float32)
    mask = rg.random((2, N)) > 0.25
    ct = rg.normal(size=(2, N, F)).astype(np.float32)
    return x, mask, ct


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world("mesh_and_collectives", 2,
                     tmp_path_factory.mktemp("mesh"), *_bn_inputs())


def test_initialize_distributed_is_a_noop_for_one_process(monkeypatch):
    import torch.distributed as dist

    from bathymetric_gnn_tpu_torch.parallel.mesh import initialize_distributed

    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    info = initialize_distributed()
    assert info == {"processes": 1, "process_id": 0, "local_devices": 1,
                    "global_devices": 1}
    assert not dist.is_initialized()


def test_initialize_distributed_never_swaps_nccl_for_gloo(tmp_path):
    """Without device="cpu" the group is NCCL's; with no card that raises
    (no fallback to gloo) before any group starts."""
    import torch.distributed as dist

    from bathymetric_gnn_tpu_torch.parallel.mesh import initialize_distributed

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: NCCL would start")
    with pytest.raises(RuntimeError, match="NCCL"):
        initialize_distributed(f"file://{tmp_path}/store", 1, 0)
    assert not dist.is_initialized()


def test_initialize_distributed_idempotent_in_a_world_of_two(world2):
    for rank, res in enumerate(world2):
        first, again = res["init"]
        assert first == again == {"processes": 2, "process_id": rank,
                                  "local_devices": 1, "global_devices": 2}
        assert res["pg"] == "gloo"


def test_host_mesh_layout_and_refusal(world2):
    for res in world2:
        assert res["host_mesh"] == (("data", "graph"), [[0, 1]])
        assert "not divisible by graph=3" in res["host_mesh_refusal"]


def test_host_mesh_refuses_a_graph_axis_across_hosts_unevenly(monkeypatch):
    """``mesh.py:111-114``'s refusal: 8 ranks, 3 a node, graph 4 (the
    check runs before any group is made)."""
    import torch.distributed as dist

    from bathymetric_gnn_tpu_torch.parallel.mesh import make_host_mesh

    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 8)
    with pytest.raises(ValueError, match="spans hosts unevenly"):
        make_host_mesh(graph_axis=4, local_world_size=3)


def test_each_rank_keeps_its_slice(world2):
    tiles = np.arange(2 * 6 * 3.0).reshape(2, 6, 3)
    for rank, res in enumerate(world2):
        np.testing.assert_array_equal(
            res["shard"]["a"], np.arange(16.0).reshape(8, 2)[4 * rank:
                                                             4 * rank + 4])
        np.testing.assert_array_equal(res["shard"]["b"][0],
                                      np.arange(4 * rank, 4 * rank + 4))
        assert res["shard"]["c"] is None
        np.testing.assert_array_equal(res["host_local"],
                                      tiles[:, 3 * rank:3 * rank + 3])
        np.testing.assert_array_equal(res["host_local_plain"]["t"], tiles)


def test_all_reduce_sum_and_its_transpose(world2):
    want = np.arange(4.0) * (1 + 2)
    for res in world2:
        y, grad = res["ars"]
        np.testing.assert_array_equal(y, want)
        # d/dx_r of sum_r' (y . c_r') = sum_r' c_r' = 2 + 3
        np.testing.assert_array_equal(grad, np.full(4, 5.0))


def test_halo_rows_split_forward_and_backward(world2):
    h0, h1 = (r["halo"] for r in world2)
    z = np.zeros((2, 3), np.float32)
    np.testing.assert_array_equal(h0["fa"], z)
    np.testing.assert_array_equal(h0["fb"], h1["x"][:2])
    np.testing.assert_array_equal(h1["fa"], h0["x"][-2:])
    np.testing.assert_array_equal(h1["fb"], z)
    np.testing.assert_array_equal(
        h0["ext"], np.concatenate([z, h0["x"], h1["x"][:2]]))
    # the gradient of each rank's sum over its received rows lands on the
    # sender's boundary rows: rank 0's last rows carry rank 1's ca
    np.testing.assert_array_equal(h0["grad"][:3], 0.0)
    np.testing.assert_allclose(h0["grad"][3:], h1["ca"], rtol=1e-6)
    np.testing.assert_allclose(h1["grad"][:2], h0["cb"], rtol=1e-6)
    np.testing.assert_array_equal(h1["grad"][2:], 0.0)
    # against autograd of the same sums on the concatenated rows
    xs = torch.from_numpy(np.concatenate([h0["x"], h1["x"]])
                          ).requires_grad_()
    loss = ((xs[5:7] * torch.from_numpy(h0["cb"])).sum()
            + (xs[3:5] * torch.from_numpy(h1["ca"])).sum())
    loss.backward()
    np.testing.assert_allclose(
        np.concatenate([h0["grad"], h1["grad"]]), xs.grad.numpy(),
        rtol=1e-6)


def _jax_sharded_bn(x, mask, ct):
    """The JAX module under shard_map over 2 devices (axis "graph"), on
    bf16 inputs: (y, running mean, running var, dx)."""
    bn = JaxBN(F, axis_name="graph")
    xb = jnp.asarray(x.reshape(2 * N, F), jnp.bfloat16)
    variables = JaxBN(F).init(jax.random.PRNGKey(0), xb[:N],
                              jnp.ones(N, bool))
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("graph",))

    def local(v, xx, mm, cc):
        def f(xx):
            y, upd = bn.apply(v, xx, mm, fuse_relu=True,
                              mutable=["batch_stats"])
            return jnp.sum(y * cc), (y, upd["batch_stats"])
        (_, (y, st)), dx = jax.value_and_grad(f, has_aux=True)(xx)
        return y, st["mean"], st["var"], dx

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P(), variables), P("graph"),
                  P("graph"), P("graph")),
        out_specs=(P("graph"), P(), P(), P("graph")), check_vma=False))
    y, mean, var, dx = fn(variables, xb, jnp.asarray(mask.reshape(-1)),
                          jnp.asarray(ct.reshape(2 * N, F)))
    return (np.asarray(y), np.asarray(mean), np.asarray(var),
            np.asarray(dx, np.float32))


def test_sync_bn_bf16_takes_the_f32_path_and_matches_jax(world2):
    x, mask, ct = _bn_inputs()
    y, mean, var, dx = _jax_sharded_bn(x, mask, ct)
    assert y.dtype == np.float32
    for rank, res in enumerate(world2):
        bn = res["bn"]
        assert bn["dtype"] == "torch.float32" and bn["lowp_calls"] == 0
        sl = slice(rank * N, (rank + 1) * N)
        np.testing.assert_allclose(bn["y"], y[sl], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(bn["mean"], mean, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(bn["var"], var, rtol=1e-5)
        np.testing.assert_allclose(bn["dx"], dx[sl], rtol=2e-2, atol=1e-3)
    # the moments are the unsharded ones (of the bf16 values, in f32)
    xs = torch.from_numpy(x.reshape(2 * N, F)).to(torch.bfloat16).float()
    m = torch.from_numpy(mask.reshape(-1))
    mu = xs[m].mean(0)
    unbiased = xs[m].var(0, unbiased=True)
    np.testing.assert_allclose(world2[0]["bn"]["mean"], 0.1 * mu.numpy(),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(world2[0]["bn"]["var"],
                               0.9 + 0.1 * unbiased.numpy(), rtol=1e-5)
