"""The model FLOPs of the rounds the traced run timed untraced (its
window's first half; the family's ``round_flops``: local train forward
and backward, four reward forwards a candidate of Omega, one evaluation
forward, the mix) over their host time times the card's data-sheet peak
at the cell's dtype, in %."""
from bench.work import PEAK_FLOPS


def read(run):
    if not run.untraced_rounds or not run.untraced_s:
        return None
    flops = run.flops_per_round * run.untraced_rounds
    return 100.0 * flops / (run.untraced_s
                            * PEAK_FLOPS[run.cell.config["dtype"]])
