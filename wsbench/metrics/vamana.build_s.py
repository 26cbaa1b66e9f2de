"""Seconds of the graph build in set-up: the host clock around the
postfilter's call of build_vamana_graph, ended by a synchronise."""

UNIT, LAYER, MOVES, SOURCE = "s", "models.vamana: graph build", "setup_s", "host_clock"
TIMERS = [("models.vamana.build_vamana_graph", "rangefilteredann_tpu_torch.models.postfilter_vamana",
           "build_vamana_graph")]


def read(run):
    calls = run.timers.get(TIMERS[0][0])
    return sum(calls) if calls else None
