"""Mean device ms a step from the forward's end to the optimizer's step: the loss and the backward."""


def read(r):
    return r.mean_ms("train_backward")
