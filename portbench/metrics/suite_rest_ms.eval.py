"""Ms a suite that run_benchmark spends outside both of its own timers:
the eval.suite span less the eval.steploop and eval.scoring spans in it.
Standard error also gets the suite's device idle by program span and the
window's time outside the two timers, from the same run."""

from portbench.harness import program_spans


def read(raw):
    program_spans.idle_ms(raw, "eval")
    program_spans.untimed_ms(raw)
    return program_spans.self_ms(raw, "eval", "eval.suite",
                                 ("eval.steploop", "eval.scoring"))
