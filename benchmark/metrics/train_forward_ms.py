"""Mean device ms a step of the train-mode forward, by CUDA events at the model's hooks."""


def read(r):
    return r.mean_ms("train_forward")
