"""% of the run's train steps on the card (set-up, window and traced
segment) that replayed the program's CUDA graphs of the step: its
`train_step.replays` over those and its `train_step.eager_steps`. None
where the program keeps no such counters or took no step on a card."""

from benchmark import program


def read(r):
    step = program.module("train.step").train_step
    replays = getattr(step, "replays", None)
    eager = getattr(step, "eager_steps", None)
    if replays is None or eager is None or replays + eager == 0:
        return None
    return 100.0 * replays / (replays + eager)
