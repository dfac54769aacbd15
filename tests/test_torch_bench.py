"""``bench_torch.py``, the port's measuring program, on the CPU.

Its timing needs the card; here its parts run at small sizes:

- ``--accuracy``'s float64 reference (bench.py's, reading the port's
  parameters): against a float64 run of the port's own plain ops, and with
  the JAX package's ``channelized_step`` (parameters carried across by
  ``convert``) and the port's step scored against it. At "highest" and on
  8-bit-grid input at "u8exact" both float32 chains sit at their float32
  floors (the port's ~139 dB, the JAX package's ~146 dB on this CPU: the
  order of the CPU BLAS's float32 sums in the banded FIRs; the port's FIRs
  in float64 read ~151 dB), so there each must clear 130 dB; where the
  law decides the SNR (u8exact on float32 noise, ~40 dB: the frames
  rounded to bfloat16) the two agree within 0.5 dB (PERF.md section 2's
  tier rule). The JAX step computes u8exact as HIGHEST off the TPU, so it
  is handed the JAX package's explicit form of the law, as
  ``tests/test_torch_tiers.py`` does;
- ``--parity`` at C=128 on a short block, with bench.py's keys and bounds;
- the search against stand-in timers; the H100 roofline's kernel #1 term;
  the headline line's keys and selection;
- the sweep's point helpers at a small width; ``--soak`` and
  ``--recovery`` on ``--device cpu`` (keys, consumers fed, a recovery
  seen; nothing about real time);
- the script refuses without a card unless ``--device cpu`` is given.
"""

import inspect
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch as bt
from webradio_tpu.ops import channelizer as jchan
from webradio_tpu.pipeline import channelized as jch
from webradio_tpu_torch import convert
from webradio_tpu_torch.ops import channelizer as tchan
from webradio_tpu_torch.ops import tail_tm
from webradio_tpu_torch.ops.nco import nco_mix_tm_fast
from webradio_tpu_torch.pipeline import channelized as tch

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))

REPO = pathlib.Path(__file__).resolve().parent.parent
C, BLOCK = 16, 12_800  # the smallest block the step's grids allow
RX = bt.offset_ifs(C)
CPU = torch.device("cpu")
FLOAT32_FLOOR_DB = 130.0
TIER_SLACK_DB = 0.5


def _cfgs(pfb):
    return (jch.ChannelizedConfig(num_channels=C, block_frames=BLOCK,
                                  pfb_precision=pfb),
            tch.ChannelizedConfig(num_channels=C, block_frames=BLOCK,
                                  pfb_precision=pfb))


def _u8_law(cfg, params, pfb_hist, iq, split):
    """The JAX package's explicit u8exact law (its step runs HIGHEST off
    the TPU)."""
    return jchan.pfb_channelize_direct_tm_u8(
        iq, params.pfb_weights_split, cfg.num_bins, pfb_hist, split=split)


# ---- --accuracy's reference -------------------------------------------------
def test_reference_is_the_ports_math_in_float64():
    _, cfg = _cfgs("highest")
    p = tch.make_channelized_params(cfg, RX, 80_000, 8_000, "FM",
                                    device="cpu")
    x = bt.accuracy_signals(cfg, RX)["fm_tones"].astype(np.float32)
    ref = bt.f64_reference(cfg, p, x.astype(np.float64))
    # the port's plain ops, every tensor in float64 (the LO is the step's
    # float32 factored phasor, the atan2 polynomial is good to ~1e-9)
    dd = lambda t: t.double()
    kp = cfg.proto_taps
    f2, _ = tchan.pfb_frames_tm(dd(torch.from_numpy(x)), kp, cfg.num_bins,
                                torch.zeros(2, kp - 1, dtype=torch.float64))
    y = f2 @ dd(p.pfb_weights).reshape(2 * kp, 2 * C)
    zeros = torch.zeros(C, dtype=torch.int64)
    mi, mq = nco_mix_tm_fast(y[:, :C], y[:, C:], zeros, p.residual_step)
    hist = lambda n: torch.zeros(n, C, dtype=torch.float64)
    audio = tail_tm.tail_after_mix_tm(
        mi, mq, dd(p.chan_toep), dd(p.audio_toep), cfg.audio_decim, p.mode,
        hist(63), hist(63), hist(2), hist(63))[0]
    assert ref.shape == (C, cfg.audio_frames)
    assert np.abs(ref).max() > 1e-2
    assert bt.snr_db(ref, audio.numpy().T) > 150.0


@pytest.mark.parametrize("pfb", ["highest", "u8exact"])
def test_accuracy_reference_scores_the_port_as_the_jax_step(pfb,
                                                             monkeypatch):
    jcfg, tcfg = _cfgs(pfb)
    jp = jch.make_channelized_params(jcfg, RX, 80_000, 8_000, "FM")
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    if pfb == "u8exact":
        monkeypatch.setattr(jch, "_channelize_tm", _u8_law)
    signals = bt.accuracy_signals(tcfg, RX)
    step = jax.jit(lambda x: jch.channelized_step(
        jcfg, jp, jch.init_channelized_state(jcfg), x)[1])
    snr = {}
    for name in ("noise", "u8_noise"):
        x = signals[name].astype(np.float32)
        ref = bt.f64_reference(tcfg, tp, x.astype(np.float64))
        got_jax = np.asarray(step(jnp.asarray(x)), np.float64)
        _, audio, _ = tch.channelized_step(
            tcfg, tp, tch.init_channelized_state(tcfg, "cpu"),
            torch.from_numpy(x))
        snr[name] = (bt.snr_db(ref, audio.double().numpy()),
                     bt.snr_db(ref, got_jax))
    floors = [("u8_noise", snr["u8_noise"])]
    if pfb == "highest":
        floors.append(("noise", snr["noise"]))
    else:
        # the law decides: bfloat16 frames of float32 noise
        port, jx = snr["noise"]
        assert port < 60.0
        assert abs(port - jx) <= TIER_SLACK_DB, snr
    for name, (port, jx) in floors:
        assert port > FLOAT32_FLOOR_DB and jx > FLOAT32_FLOOR_DB, (name, snr)


def test_accuracy_mode_on_the_cpu():
    pairs = (("highest", "highest"), ("hx5", "u8exact"),
             ("highest", "bf16"))
    out = bt.accuracy(CPU, c=C, block_frames=BLOCK, pairs=pairs)
    assert out["metric"] == "channelized_audio_snr_db_vs_float64"
    assert out["device"] == "cpu"
    keys = [f"{s}_fir_{f}_pfb_{p}" for s in ("noise", "fm_tones", "u8_noise")
            for f, p in pairs]
    assert all(np.isfinite(out[k]) for k in keys)
    assert out["kernel_launches"] == 0  # the CPU: the plain versions
    assert out["fm_tones_fir_highest_pfb_highest"] > FLOAT32_FLOOR_DB
    # the bfloat16-stored product costs the FM tones tens of dB of that
    assert (out["fm_tones_fir_highest_pfb_bf16"]
            < out["fm_tones_fir_highest_pfb_highest"] - 20.0)
    assert len(bt.ACCURACY_PAIRS) == 11
    pairs_src = f"{bt.ACCURACY_PAIRS}".replace(" ", "").replace("'", '"')
    assert pairs_src in inspect.getsource(bench.accuracy).replace(
        " ", "").replace("\n", "")


# ---- --parity ---------------------------------------------------------------
def test_parity_keys_and_bounds_are_bench_pys():
    res = bt.parity_check(CPU, c=bt.PARITY_C, block_frames=BLOCK)
    names = {f"hx_{t}_{m}" for m in ("USB", "FM") for t in ("hx5", "hx4")}
    names |= {"u8exact_USB", "u8exact_FM"}
    assert names <= set(res)
    assert res["ok"] is True and res["kernel_launches"] == 0
    # the port computes hx5 and hx4 as highest: the same arithmetic (the
    # CPU BLAS may round a product differently from one call to the next)
    assert all(res[f"hx_{t}_{m}"] <= 1e-7 for t in ("hx5", "hx4")
               for m in ("USB", "FM"))
    assert 0 < res["u8exact_FM"] <= bt.U8_BOUND
    src = inspect.getsource(bench.parity_check).replace(" ", "")
    assert '(("USB",2e-6),("FM",3e-6))' in src
    assert bt.HX_BOUNDS == (("USB", 2e-6), ("FM", 3e-6))
    assert bt.U8_BOUND == 3e-6 and src.count("3e-6)") >= 2
    assert bt.PARITY_C == 128 and "c=128" in src


# ---- the search -------------------------------------------------------------
def _brute(cost, step=1_024, top=2_000_000):
    return max((c for c in range(step, top, step) if cost(c) <= bt.BLOCK_MS),
               default=0)


@pytest.mark.parametrize("cost", [
    lambda c: 0.3 + c * 42.0 / 111_000,  # "highest"'s predicted line
    lambda c: 0.5 + 42.67 * c / 300_000,  # a lossy tier's
    lambda c: 1.0 + c * 1e-6 + (c > 50_000) * 100.0,  # a cliff
    lambda c: 42.67 * (c / 200_000) ** 4,  # convex
], ids=["highest", "lossy", "cliff", "convex"])
def test_search_finds_the_largest_multiple_under_the_block(cost):
    found = bt.search_realtime(cost, budget=30)
    assert found["best"] == _brute(cost)
    assert found["resolution"] == bt.SWEEP_STEP
    assert cost(found["best"]) <= bt.BLOCK_MS < cost(found["miss"])


def test_search_stays_in_its_budget():
    cost = lambda c: 42.67 * (c / 200_000) ** 4
    found = bt.search_realtime(cost)
    assert len(found["points"]) == bt.SWEEP_POINTS
    assert cost(found["best"]) <= bt.BLOCK_MS < cost(found["miss"])
    # the near-linear cost of the card's step needs six points
    line = bt.search_realtime(lambda c: 0.3 + c * 42.0 / 111_000)
    assert len(line["points"]) <= 6 and line["best"] == 111_616


@pytest.mark.parametrize("oom", [None, 400_000], ids=["timed", "oom"])
def test_search_closes_on_a_noisy_line(oom):
    # the card's step: linear in C with ~0.2 ms of run-to-run spread (the
    # bf16 tier on the H100; probes near the crossing hit or miss by chance)
    rng = np.random.default_rng(12)

    def noisy(c):
        if oom and c > oom:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return 0.15 + 0.1437 * c / 1_000 + rng.normal(0.0, 0.2)

    for _ in range(50):
        found = bt.search_realtime(noisy)
        assert len(found["points"]) <= bt.SWEEP_POINTS
        assert found["resolution"] <= 8 * bt.SWEEP_STEP
        assert 285_000 < found["best"] < 305_000


def test_search_counts_out_of_memory_as_a_miss_and_raises_the_rest():
    seen = []

    def measure(c):
        if c > 70_000:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return c * 1e-4

    found = bt.search_realtime(measure, budget=30,
                               on_oom=lambda c, e: seen.append(c))
    assert found["best"] == 69_632 and found["miss"] == 70_656
    assert seen and all(c > 70_000 for c in seen)
    assert (131_072, None) in found["points"]

    # the "default" tier on the H100: doubling ran out of memory at
    # 524,288 and 393,216 above a crossing near 280k
    def default_tier(c):
        if c > 360_000:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return 0.15 + c * 39.84 / 262_144

    found = bt.search_realtime(default_tier)
    assert found["best"] == _brute(lambda c: 0.15 + c * 39.84 / 262_144)
    assert found["resolution"] == bt.SWEEP_STEP
    assert len(found["points"]) <= bt.SWEEP_POINTS

    def broken(c):
        raise RuntimeError("CUDA error: an illegal memory access")

    with pytest.raises(RuntimeError, match="illegal memory access"):
        bt.search_realtime(broken)


# ---- the roofline and the headline line -------------------------------------
def test_roofline_kernel1_term_is_perf_section6_bound():
    r = bt.roofline_ms(1_024, "highest")
    assert r["tail_ms"] == pytest.approx(0.0456, rel=0.01)
    assert r["tail_ms"] == r["tail_ops_ms"] > r["tail_bytes_ms"]
    # u8exact doubles the GEMM's K, "high" triples it, both on bfloat16
    ops = {t: bt.roofline_ms(65_536, t)["front_ops_ms"] for t in bt.PFB_TIERS}
    assert ops["u8exact"] == pytest.approx(2 * ops["default"])
    assert ops["high"] == pytest.approx(3 * ops["default"])
    assert ops["highest"] == pytest.approx(
        ops["default"] * bt.PEAK_BF16_FLOPS / bt.PEAK_FP32_FLOPS)
    assert ops["bf16"] == ops["default"]
    b = {t: bt.roofline_ms(65_536, t)["front_bytes_ms"] for t in bt.PFB_TIERS}
    assert b["bf16"] < b["default"] < b["highest"]


def _result(c, fir, pfb, ms):
    return {"kind": "result", "path": "pfb", "key": bt.point_key(c, fir, pfb),
            "channels": c, "precision": fir, "pfb_precision": pfb,
            "step_ms": ms, "one_ms": ms + 0.1, "rt_channels": c * 42.67 / ms,
            "realtime": ms <= bt.BLOCK_MS, "peak_gb": 1.0,
            "roofline_frac": bt.roofline_ms(c, pfb)["ideal_ms"] / ms}


def test_summary_lines_keep_bench_pys_keys():
    records = [
        {"kind": "parity", "ok": True, "hx_hx5_FM": 0.0, "u8exact_FM": 1e-7},
        _result(110_592, "highest", "highest", 42.0),
        _result(111_616, "highest", "highest", 43.0),
        _result(280_576, "highest", "u8exact", 42.5),
        _result(330_752, "highest", "bf16", 42.6),
        _result(110_592, "hx5", "highest", 42.1),
        {"kind": "error", "key": "pfb_c524288_pfbbf16",
         "error": "OutOfMemoryError: ..."},
        {"kind": "search", "pfb_precision": "highest", "best": 110_592,
         "miss": 111_616, "resolution": 1_024, "points": [[1, 2]] * 6},
        {"kind": "result", "path": "direct", "channels": 4, "step_ms": 1.0,
         "one_ms": 1.2, "rt_channels": 170.7, "realtime_factor": 42.7},
    ]
    detail, final = bt.summarize(records)
    src = inspect.getsource(bench.main)
    for key in ("realtime_channels_bitexact", "realtime_channels_f32parity",
                "realtime_channels_bf16x3", "realtime_channels_bf16product",
                "realtime_channels_max_any_tier", "roofline_frac",
                "realtime_channels_reference_quality",
                "realtime_channels_reference_quality_u8input",
                "realtime_channels_u8input_f32parity", "best_precision",
                "best_batch", "parity_ok", "vs_baseline", "unit", "value"):
        assert f'"{key}"' in src and key in final, key
    assert final["metric"] == "realtime_nbfm_channels_per_chip"
    # bench.py's rule: the bit-exact FIR tier over every product but bf16
    assert final["value"] == 280_576.0 == final["realtime_channels_bitexact"]
    assert final["realtime_channels_bf16product"] == 330_752
    assert final["realtime_channels_max_any_tier"] == 330_752
    assert final["realtime_channels_reference_quality"] == 110_592
    assert final["realtime_channels_by_pfb"]["u8exact"] == 280_576
    assert final["roofline_frac"] == pytest.approx(
        bt.roofline_ms(280_576, "u8exact")["ideal_ms"] / 42.5, abs=1e-3)
    assert detail["detail"]["pfb_c524288_pfbbf16_error"].startswith("OutOf")
    assert detail["detail"]["pfb_c280576_pfbu8exact_roofline_frac"] == (
        final["roofline_frac"])
    assert detail["searches"]["highest"]["points"] == 6
    assert detail["detail"]["direct_c4_step_ms"] == 1.0


# ---- the sweep's point helpers, small ---------------------------------------
def test_point_helpers_on_the_cpu():
    iq = bt.bench_iq(CPU, BLOCK)
    timing = {"steps": 2, "repeats": 1, "one_at_a_time": 1}
    rec = bt.channelized_point(128, "highest", "bf16", iq, **timing)
    assert rec["key"] == "pfb_c128_pfbbf16" and rec["blocks"] == 5
    assert rec["kernel_launches"] == 0 and rec["peak_gb"] is None
    assert rec["step_ms"] > 0 and rec["realtime"] == (
        rec["step_ms"] <= 1e3 * BLOCK / bt.SAMPLE_RATE)
    assert rec["graph"]["replays"] == 0  # no graphs on the CPU
    d = bt.direct_point(4, iq, **timing)
    assert d["path"] == "direct" and d["step_ms"] > 0


# ---- the live modes on the CPU ----------------------------------------------
def test_soak_on_the_cpu():
    res = bt.soak(seconds=2, capacity=16, consumers=2, settle=1.0,
                  device="cpu")
    for key in ("ok", "blocks", "blocks_expected", "dropped_blocks",
                "audio_format", "audio_stream_bytes", "waterfall_polls",
                "engine", "graph"):
        assert key in res, key
    assert res["device"] == "cpu" and res["engine"] == "channelized"
    assert res["audio_format"] == bt.audio_format()
    assert res["audio_consumers"] == 2
    header = 44 if res["audio_format"] == "wav" else 0
    assert all(b > header for b in res["audio_stream_bytes"])
    assert res["pump_failed"] is None


def test_recovery_on_the_cpu():
    res = bt.recovery(stall_ms=300, capacity=16, settle=1.0, window=1.0,
                      device="cpu")
    for key in ("ok", "ring_drops_during_stall", "expected_drops_at_most",
                "max_backlog_seen", "recovery_ms_after_stall",
                "post_recovery_blocks", "steady_state_drops", "graph"):
        assert key in res, key
    assert res["ready"] and res["ring_blocks"] == 4
    assert 0 <= res["backlog_after_stall"] <= 4
    assert res["recovery_ms_after_stall"] is not None
    assert res["expected_drops_at_most"] == max(0, int(300 / bt.BLOCK_MS) - 4)
    assert res["pump_failed"] is None


# ---- the command line -------------------------------------------------------
def _run(args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "bench_torch.py", *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)


@pytest.mark.parametrize("args", [[], ["--parity"], ["--soak", "2", "16"],
                                  ["--device", "cpu"]],
                         ids=["sweep", "parity", "soak", "sweep-on-cpu"])
def test_refuses_without_a_card(args):
    out = _run(args)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA" in out.stderr or "card" in out.stderr
