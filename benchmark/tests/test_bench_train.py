"""A training cell, driven through a whole run of the tiny LC model's
train step on the CPU: the unbroken run is correct; a step that leaves the
state unchanged, or one that leaves half of the batch out, is not."""

from __future__ import annotations

from benchmark import run
from benchmark.faults import half_batch, state_unchanged
from benchmark.tests.tiny import tiny_train_cell

# the port's CPU path runs the reference's code; the CPU's threaded sums
# leave ~1e-7 in the loss, which AdamW's first steps lift to ~1e-3 in the
# change of a parameter whose gradient has entries near its epsilon
LIMITS = {"loss1": 1e-5, "loss2": 1e-5, "loss3": 1e-5, "grad_median": 1e-4,
          "update_median": 1e-2, "counts": 0}
SEED = 2 ** 32 + 5


def test_unbroken_train_run_is_correct(tmp_path):
    r = run.run_cell(tiny_train_cell(tmp_path, LIMITS), SEED, 0.1, False,
                     device="cpu")
    assert r["correct"], r["compared"]
    assert set(r["numbers"]) == set(LIMITS)


def test_state_left_unchanged_reads_one(tmp_path):
    r = run.run_cell(tiny_train_cell(tmp_path, LIMITS), SEED, 0.1, False,
                     device="cpu", fault=state_unchanged)
    assert not r["correct"]
    assert abs(r["numbers"]["update_median"] - 1.0) < 1e-6


def test_half_batch_is_not_correct(tmp_path):
    r = run.run_cell(tiny_train_cell(tmp_path, LIMITS), SEED, 0.1, False,
                     device="cpu", fault=half_batch)
    assert not r["correct"]
    assert r["numbers"]["loss1"] > 100 * LIMITS["loss1"]
    assert r["numbers"]["counts"] > 0
