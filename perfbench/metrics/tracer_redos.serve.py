"""Views the serve loop redid in the window because their traces overflowed
the tracer's budgets (evaluate.render_set's redo, counted by the loop)."""


def read(t):
    return t.counts.get("tracer_redos")
