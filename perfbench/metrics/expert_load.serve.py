"""How evenly the router loads the routed experts over the profiled
requests: for each expert layer, the rows of its most loaded expert over
the mean rows of its experts, then the mean over the layers (1.0 is even).
Read from the program's device counter ``moe.expert_rows`` ([layers,
experts], added to by each routing step while spans record).  None where
the program keeps no such counter."""


def read(ctx):
    try:
        from loongx_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "counters"):
        return None
    rows = profiling.counters().get("moe.expert_rows")
    if rows is None:
        return None
    rows = rows.double()
    mean = rows.mean(-1)
    used = mean > 0
    if not bool(used.any()):
        return None
    return float((rows.amax(-1)[used] / mean[used]).mean())
