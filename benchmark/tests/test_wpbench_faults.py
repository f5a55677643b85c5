"""The check sees a broken timed path.  Each run skips the look for a
card and drives the rest of a run on the program's CPU path, with a fault
planted underneath, and `correct` has to come out false; the control (the
reference with its longest match capped) too.  Unbroken, the same runs
are correct."""

import time

import numpy as np
import pytest
from test_wpbench_run import run_small

import control
from wpbench import cell


def encoder_with(name, patch):
    """A stand-in for the program: the configuration's encoder with
    `patch(encoder, mix)` applied to it (`mix`: the cell's traffic mix)."""
    def make(root):
        c = cell.Cell(name, root=str(root))
        base = cell.program(c, "cpu")

        def build(lines):
            enc = base(lines)
            patch(enc, c.mix)
            return enc
        return build
    return make


def alter_first_fetched_id(enc, mix):
    """A token altered where it is produced: the card's output, as fetched."""
    if hasattr(enc, "_fetch_buckets"):  # fast: the word kernel's emits
        real = enc._fetch_buckets

        def fetch(handle):
            emits = real(handle)
            for e in emits:
                if e.size:
                    e.reshape(-1)[0] += 1
                    break
            return emits
        enc._fetch_buckets = fetch
    else:  # linear: the batch's ids
        real = enc._fetch_batch

        def fetch(handle):
            ids, positions = real(handle)
            ids = ids.copy()
            ids[:1] += 1
            return ids, positions
        enc._fetch_batch = fetch


def drop_half(enc, mix):
    """Half of the answer left out: the call returns its first half."""
    real = enc.encode_bytes
    enc.encode_bytes = lambda doc: (lambda ids: ids[: ids.shape[0] // 2])(real(doc))


def raise_on_call(enc, mix):
    """An answer that never comes: the window's first call raises, the one
    after the mix's warm-up calls, so however few calls a loaded host fits
    into the window, the fault fires."""
    real, calls = enc.encode_bytes, []

    def fail(doc):
        calls.append(doc)
        if len(calls) == int(mix["warmup_calls"]) + 1:
            raise RuntimeError("planted fault")
        return real(doc)
    enc.encode_bytes = fail


def stall_fetch(enc, mix):
    """A fetch that misses its deadline, which the CPU path rescues."""
    real = enc._fetch_buckets
    enc.DEVICE_FETCH_TIMEOUT_S = enc.DEVICE_FIRST_FETCH_TIMEOUT_S = 0.01

    def fetch(handle):
        time.sleep(0.05)
        return real(handle)
    enc._fetch_buckets = fetch


FAULTS = [
    ("fast.wiki-en-articles", alter_first_fetched_id, "verify_repairs"),
    ("fast.wiki-en-10MB", alter_first_fetched_id, "verify_repairs"),
    ("linear.wiki-en-articles", alter_first_fetched_id, "ids_wrong"),
    ("linear.wiki-en-10MB", alter_first_fetched_id, "ids_wrong"),
    ("fast.wiki-en-10MB", drop_half, "ids_wrong"),
    ("linear.wiki-en-articles", drop_half, "ids_wrong"),
    ("fast.wiki-en-articles", raise_on_call, "calls_failed"),
    ("linear.wiki-en-10MB", raise_on_call, "calls_failed"),
    ("fast.wiki-en-articles", stall_fetch, "device_fallbacks"),
]


@pytest.mark.parametrize("name,fault,caught_by", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f, _ in FAULTS])
def test_a_planted_fault_is_not_correct(small_root, name, fault, caught_by):
    out = run_small(small_root, name, False, make=encoder_with(name, fault)(small_root))["result"]
    assert out["correct"] is False
    assert out["compared"][caught_by]["value"] > out["compared"][caught_by]["limit"]
    if fault is raise_on_call:  # the window's first call: nothing else attempted
        assert out["compared"]["calls_failed"]["value"] == 1 and out["attempted"] == 1


@pytest.mark.parametrize("seed", [11, 2**31 + 12, 2**32 + 13])
@pytest.mark.parametrize("name", ["fast.wiki-en-10MB", "linear.wiki-en-articles"])
def test_the_control_is_not_correct(small_root, name, seed):
    r = control.readings(cell.Cell(name, root=str(small_root)), seed, 0.5, device="cpu")
    assert r["correct"] is False and r["ids_wrong"] > 0 and r["calls_checked"] >= 1


def test_unbroken_the_same_runs_are_correct(small_root):
    for name in {n for n, _, _ in FAULTS}:
        ok = run_small(small_root, name, False, make=encoder_with(name, lambda enc, mix: None)(small_root))
        assert ok["result"]["correct"] is True
        assert np.all([v["value"] == 0 for v in ok["result"]["compared"].values()])
