"""Renders a step redid because a budget overflowed
(`train.trainer.Trainer`'s redo loop): the program's `trainer.redo` events
per step. A trace without the program's `trainer.pick` span comes from a
program that records no such events, and reads nothing."""


def read(t):
    if not t.has_span("trainer.pick"):
        return None
    return sum(1 for h in t.host if h[0] == "trainer.redo") / t.units
