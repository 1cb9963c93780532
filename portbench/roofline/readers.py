"""Arithmetic shared by the per-layer metric readers (``metrics/``)."""

from __future__ import annotations

import json
from typing import Callable, Optional, Sequence

from portbench.roofline import h100


def kernel_roofline(ctx, calls_key: str, patterns: Sequence[str],
                    launches_per_call: int,
                    bound_ms: Callable[[dict], float]) -> Optional[float]:
    """A kernel's share of its roofline, in %: the least time of the calls
    the window made (``bound_ms`` of each call's dims, from the driver's
    ``kernel_calls[calls_key]``) over the device time of the kernels whose
    names hold one of ``patterns``. None where the window made no such
    call. The launches the trace holds must be the launches those calls
    make: a trace that lost or gained one raises, and no share is
    printed."""
    calls = ctx["result"]["kernel_calls"].get(calls_key)
    if not calls:
        return None
    want = sum(calls.values()) * launches_per_call
    got = ctx["trace"].kernels(patterns)
    if len(got) != want:
        raise RuntimeError(
            f"the trace holds {len(got)} launches of {list(patterns)}, the "
            f"window's {sum(calls.values())} calls make {want}: the "
            "profiler lost or added kernels, so no roofline share is read")
    least = sum(bound_ms(json.loads(k)) * n for k, n in calls.items())
    spent = sum(d for _n, _t, d in got) * 1e-3
    return 100.0 * least / spent


def model_flops_share(ctx) -> float:
    """The window's model operations over the traced window at the card's
    fastest f32-accurate rate (3xTF32 on the tensor cores), in %."""
    return 100.0 * ctx["result"]["flops"] / (
        ctx["trace"].window_s * h100.MMA_FLOPS["float32"])


def idle_share(ctx) -> float:
    """The share of the traced window in which no kernel, copy or set ran
    on the device, in %."""
    t = ctx["trace"]
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def span_mean_ms(ctx, names: Sequence[str], per: str) -> Optional[float]:
    """The harness spans ``names`` summed, in ms per ``per`` counted in
    the driver's ``counts``."""
    times = ctx["spans"].times
    n = ctx["result"]["counts"].get(per, 0)
    if not n or not any(k in times for k in names):
        return None
    return 1e3 * sum(sum(times.get(k, ())) for k in names) / n
