"""Faults planted in the expert layer of the measured program
(``loongx_tpu_torch.ops.moe``), to show that a HiDream cell's check reads
them: each a context manager that patches one function of the module while
the block runs.  The harness's tests and `perfbench.calibrate_hidream` use
them; a run never does."""

from __future__ import annotations

from perfbench.faults import _patched


def _moe():
    from loongx_tpu_torch.ops import moe

    return moe


def moe_top1():
    """Each token's first expert alone: the second's weight 0."""
    def make(fn):
        def route(x, w_gate, top_k):
            idx, wts = fn(x, w_gate, top_k)
            keep = wts.new_zeros(wts.shape[1])
            keep[0] = 1.0
            return idx, wts * keep
        return route
    return _patched(_moe(), "route", make)


def moe_shared_out():
    """The shared expert left out of the routed layers' combine."""
    def make(fn):
        def combine(resid, gate, y_routed, dest, y_shared, *a):
            if dest is not None:
                y_shared = y_shared * 0
            return fn(resid, gate, y_routed, dest, y_shared, *a)
        return combine
    return _patched(_moe(), "combine", make)


def moe_renormalised():
    """The top-k weights renormalised to sum to 1."""
    def make(fn):
        def route(x, w_gate, top_k):
            idx, wts = fn(x, w_gate, top_k)
            return idx, wts / wts.sum(-1, keepdim=True)
        return route
    return _patched(_moe(), "route", make)


MOE = {"moe_top1": moe_top1, "moe_shared_out": moe_shared_out,
       "moe_renormalised": moe_renormalised}
