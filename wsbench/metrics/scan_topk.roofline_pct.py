"""The scan's share of its roofline: the least time the card could take for
the traced batches' windows (wsbench.work.scan_work on the benchmark's own
label sort, at the float32 and memory peaks) over the device time of what
ops.scan.scan_topk launched (the kernel B1 with its sort, plan and merge)."""

from wsbench.work import bound_s, scan_work

UNIT, LAYER, MOVES, SOURCE = "%", "ops.scan: the scan kernel B1", "qps", "device_trace"
SPANS = [("ops.scan.scan_topk", "rangefilteredann_tpu_torch.models.base", "scan_topk")]


def read(run):
    dev = run.trace.device_s(SPANS[0][0])
    if dev <= 0:
        return None
    d, k = run.cell.config["d"], run.cell.traffic["k"]
    per_pool = [bound_s(*scan_work(s, e, d, k)) for s, e in run.windows]
    return 100.0 * sum(per_pool[b] for b in run.which) / dev
