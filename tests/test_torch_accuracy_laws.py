"""``bench_torch.JAX_LAW_SNR_DB``, the JAX package's ``--accuracy`` SNRs
that the tier rule holds the port to on the card (every key at least the
JAX law's less ``LAW_SLACK_DB``; ``chip_smoke.py`` gates kernel #1 on it),
against the JAX step itself.

``tools/accuracy_jax.py`` runs the JAX package's ``channelized_step`` on the
CPU with each filterbank tier's explicit law, at C=128, on the three inputs
of ``bench_torch.py --accuracy`` and against its float64 reference. Here it
runs at the pairs whose keys decide the rule for kernel #1 (the
float32-accurate products: highest/highest, highest/high on 8-bit noise,
highest/u8exact on 8-bit noise; at the other keys the product's own loss
decides), and each of their three keys must equal the table to 0.1 dB,
the table's rounding.
"""

import importlib.util
import pathlib

import pytest
import torch

import bench_torch as bt

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))

TOOL = pathlib.Path(__file__).resolve().parent.parent / "tools" / \
    "accuracy_jax.py"
SIGNALS = ("noise", "fm_tones", "u8_noise")


def _tool():
    spec = importlib.util.spec_from_file_location("accuracy_jax", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fir,pfb", [("highest", "highest"),
                                     ("highest", "high"),
                                     ("highest", "u8exact")])
def test_table_is_the_jax_laws(fir, pfb):
    got = _tool().law_snrs(bt.ACCURACY_C, [(fir, pfb)])
    keys = [f"{s}_fir_{fir}_pfb_{pfb}" for s in SIGNALS]
    assert sorted(got) == sorted(keys)
    for key in keys:
        assert abs(got[key] - bt.JAX_LAW_SNR_DB[key]) <= 0.1 + 1e-9, (
            key, got[key], bt.JAX_LAW_SNR_DB[key])


def test_table_covers_every_key_and_the_rule_reads_it():
    keys = {f"{s}_fir_{f}_pfb_{p}" for s in SIGNALS
            for f, p in bt.ACCURACY_PAIRS}
    assert set(bt.JAX_LAW_SNR_DB) == keys and len(keys) == 33
    at_law = dict(bt.JAX_LAW_SNR_DB)
    assert bt.below_jax_law(at_law) == {}
    slack = {k: v - bt.LAW_SLACK_DB for k, v in at_law.items()}
    assert bt.below_jax_law(slack) == {}
    key = "u8_noise_fir_highest_pfb_high"
    miss = dict(at_law, **{key: at_law[key] - bt.LAW_SLACK_DB - 0.1})
    assert bt.below_jax_law(miss) == {key: [miss[key], at_law[key]]}
