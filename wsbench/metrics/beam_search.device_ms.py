"""Device milliseconds a batch of what the beam kernel's wrapper
(ops.beam.beam_search_inline, called by models.postfilter_vamana) launched."""

UNIT, LAYER, MOVES, SOURCE = "ms/batch", "ops.beam: the beam kernel B2", "qps", "device_trace"
SPANS = [("ops.beam.beam_search_inline", "rangefilteredann_tpu_torch.models.postfilter_vamana",
          "beam_search_inline")]


def read(run):
    if len(run.trace.intervals(SPANS[0][0])[0]) == 0:
        return None
    return run.trace.device_s(SPANS[0][0]) * 1e3 / run.batches
