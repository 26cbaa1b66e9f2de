"""Query-mode searches a batch that took the plain batched_beam_search, not
the beam kernel: the harness's spans around the postfilter's calls of it."""

UNIT, LAYER, MOVES, SOURCE = "1/batch", "ops.beam_search: the plain search route", "qps", \
    "program_span"
SPANS = [("ops.beam_search.batched_beam_search",
          "rangefilteredann_tpu_torch.models.postfilter_vamana", "batched_beam_search")]


def read(run):
    return len(run.trace.intervals(SPANS[0][0])[0]) / run.batches
