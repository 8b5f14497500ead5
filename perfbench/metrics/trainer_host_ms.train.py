"""Host milliseconds a Trainer step spends outside its TrainStep calls: the
view pick, the extras, the overflow reads and redos, the upkeep and the
logging (`train.trainer.Trainer`)."""
SPANS = [
    ("materialrefgs_torch.train.trainer", "Trainer.train", "Trainer.train"),
    ("materialrefgs_torch.train.trainer", "TrainStep.render", "TrainStep.render"),
    ("materialrefgs_torch.train.trainer", "TrainStep.update", "TrainStep.update"),
]


def read(t):
    if not t.has_span("Trainer.train"):
        return None
    outside = t.span_host_s("Trainer.train") - t.span_host_s("TrainStep.render") - t.span_host_s("TrainStep.update")
    return 1e3 * outside / t.units
