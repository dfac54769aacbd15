"""The outputs check fails what it must, on the CPU: the control (the
reference in float32 with TF32 products in the program's place) fails the
configurations' limits, and a whole run with the timed path broken
underneath comes out not correct, once for each fault a cell can have.

    python3 -m pytest benchmark/tests -q
"""

from __future__ import annotations

import pytest
import torch

from benchmark import check, control, registry, run
from benchmark.tests.test_bench_harness import REPO, stand_in


@pytest.mark.parametrize("workload", ["headline_u8.bulk", "headline_u8.live"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails_the_limits(workload, seed):
    """At the cell's own traffic, on a one-second stand-in window."""
    cell = registry.find_cell(workload, REPO)
    rec = control.stand_in(cell, seed, 1.0, 1.0, "cpu")
    numbers = check.outputs(rec, device="cpu", control=True)
    ok, checks = check.verdict(numbers, cell.config["limits"])
    assert not ok, checks


def _stale_state(r):
    """A step that returns its state unchanged: it computes the block and
    keeps no carry."""
    from webradio_tpu_torch.ops.spectrum import spectrum_db

    pipe = r.fe.pipeline

    def step(iq):
        _, audio, spectra = pipe._block(iq)
        raw = spectra[:, -1, :]
        return audio, raw, spectrum_db(raw)

    pipe._step_in_place = step


def _half_batch(r):
    """Half of the batch left out: the step's upper half of the channels is
    never computed (zeros)."""
    pipe = r.fe.pipeline
    block = pipe._block

    def half(iq):
        state, audio, spectra = block(iq)
        audio = audio.clone()
        audio[:, audio.shape[1] // 2:] = 0  # time-major [af, C]
        return state, audio, spectra

    pipe._block = half


def _altered_answer(r):
    """An answer altered where it is produced: one audio sample of one
    listened receiver's row, a hundredth of full scale off."""
    pipe = r.fe.pipeline
    block = pipe._block
    slot = r.probe.slot_of[1]

    def altered(iq):
        state, audio, spectra = block(iq)
        audio = audio.clone()
        audio[100, slot] += 0.01
        return state, audio, spectra

    pipe._block = altered


def _exchange_left_out(r):
    """The exchange between cards left out: the rows the fan-out gathers
    come back from the first card only (the others' pieces are not
    copied)."""
    from webradio_tpu_torch.parallel import sharded

    to_host = sharded.SelectedRows.to_host

    def first_card_only(self):
        self.picks = self.picks[:1]
        return to_host(self)

    r.monkeypatch.setattr(sharded.SelectedRows, "to_host", first_card_only)


def _lost_silently(r):
    """Blocks lost between publish and delivery with no count: the
    fan-out's queue forgets every item that holds a block of the compared
    sample (the sample is drawn as a block is offered, before it is
    published, so every block of the final sample is lost)."""
    queue = r.fe._fanout
    get = queue.get

    def lossy(timeout=None):
        while True:
            item = get(timeout)
            if item is None or not any(rows.seq in r.probe.keep
                                       for _, rows in item):
                return item

    queue.get = lossy


def _measure(tmp_path, fault, engine="channelized", monkeypatch=None):
    cell = registry.find_cell(stand_in(tmp_path, "bulk", engine=engine,
                                       metric=False), tmp_path)

    def hook(r):
        r.monkeypatch = monkeypatch
        fault(r)

    return run.measure(cell, 2**31 + 7, 1.0, False, device="cpu",
                       fault=None if fault is None else hook)


@pytest.mark.parametrize("fault", [_stale_state, _half_batch,
                                   _altered_answer],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered"])
def test_a_broken_step_is_not_correct(tmp_path, fault, small_run):
    out = _measure(tmp_path, fault)
    assert not out["correct"], out["checks"]
    assert out["checks"]["audio_gap"]["value"] > \
        out["checks"]["audio_gap"]["limit"]


@pytest.mark.parametrize("broken", [False, True], ids=["sound", "exchange"])
def test_the_sharded_front_end_over_four_positions(tmp_path, monkeypatch,
                                                   broken, small_run):
    """The sharded engine on a (1, 4) mesh of CPU positions: sound, it is
    correct; with the rows of cards past the first left out, it is not."""
    from webradio_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "visible_devices",
                        lambda device=None: [torch.device("cpu")] * 4)
    out = _measure(tmp_path, _exchange_left_out if broken else None,
                   engine="sharded", monkeypatch=monkeypatch)
    assert out["correct"] is not broken, out["checks"]


def test_a_block_lost_silently_is_missing(tmp_path, small_run):
    """A compared block published and never delivered, with no queue
    counting a drop, is an answer that never came: ``missing``."""
    out = _measure(tmp_path, _lost_silently)
    assert not out["correct"], out["checks"]
    assert out["checks"]["missing"]["value"] > 0
