"""The reader of `step_graph_share.speedrun`: the share of the program's
train steps that replayed its CUDA graphs, from the step's counters, and
nothing where the program keeps no such counters (a program before them)
or took no step on a card (the CPU)."""

from __future__ import annotations

from types import SimpleNamespace

from benchmark import harness, program

READ = harness.reader_of("step_graph_share.speedrun")


def test_share_of_replayed_steps(monkeypatch):
    step = program.module("train.step").train_step
    monkeypatch.setattr(step, "replays", 38, raising=False)
    monkeypatch.setattr(step, "eager_steps", 2, raising=False)
    assert READ(SimpleNamespace()) == 95.0


def test_no_counters_or_no_card_step_gives_none(monkeypatch):
    step = program.module("train.step").train_step
    monkeypatch.setattr(step, "replays", 0, raising=False)
    monkeypatch.setattr(step, "eager_steps", 0, raising=False)
    assert READ(SimpleNamespace()) is None
    monkeypatch.delattr(step, "replays")
    assert READ(SimpleNamespace()) is None
