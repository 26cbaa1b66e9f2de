"""Share of the beam kernel B2's candidates whose rows it did not stage and
score, because the same search had scored that id before: 100 x (1 - rows
scored / candidates) over the traced window, from the program's counters
ops.beam.BEAM_ROWS_SCORED and BEAM_CANDIDATES (cmps less each active query's
start), which the program sums on the card while its tracing is on."""

from wsbench import program

UNIT, LAYER, MOVES, SOURCE = "%", "ops.beam: the beam kernel B2", "qps", "program_counter"
SCORED, CANDIDATES = "ops.beam.BEAM_ROWS_SCORED", "ops.beam.BEAM_CANDIDATES"
__getattr__ = program.traced([(SCORED, f"{program.PORT}.ops.beam", "BEAM_ROWS_SCORED"),
                              (CANDIDATES, f"{program.PORT}.ops.beam", "BEAM_CANDIDATES")])


def read(run):
    scored, candidates = program.per_batch(run, SCORED), program.per_batch(run, CANDIDATES)
    if scored is None or not candidates:
        return None
    return 100 * (1 - scored / candidates)
