"""The flagship single-card step as ``(fn, example_args)``: the port's twin
of ``__graft_entry__.entry``.

The flagship model is the direct front-end block program at the
reference's stock rates (2.4 Msps -> 240 k -> 48 k, block = 102,400 IQ
frames, src/main.cxx:74-75) with a 16-receiver channel batch: IFs
``(i - 8) * 100 kHz``, 80 / 8 kHz bandwidths, laws FM, AM, USB, LSB four
times over. :func:`dryrun_multichip` is the twin of
``__graft_entry__.dryrun_multichip``: the sharded steps over an
``n``-position mesh, held to the single-device steps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .pipeline.frontend import frontend_step
from .pipeline.state import ChainConfig, init_state, make_receiver_params

#: the flagship configuration: stock rates, 16 receivers
CONFIG = ChainConfig(num_channels=16)


def entry(device: torch.device | str | None = None):
    """Return ``(fn, (params, state, iq))`` on ``device`` (None: the CUDA
    device, and an error where there is none).

    ``fn(params, state, iq)`` runs one block ``iq [2, 102400]`` (float32
    real planes, re and im) through the step and returns ``(audio [16,
    2048], latest spectrum planes [2, 512])``: the raw DFT planes of the
    block's last spectrum row. The example ``iq`` is zeros, as in the JAX
    package's entry.
    """
    cfg = CONFIG
    params = make_receiver_params(
        cfg,
        if_hz=[(i - 8) * 100_000 for i in range(16)],
        if_bandwidth_hz=80_000,
        af_bandwidth_hz=8_000,
        mode=["FM", "AM", "USB", "LSB"] * 4,
        device=device,
    )
    state = init_state(cfg, params.rx.phase_step.device)
    iq = torch.zeros((2, cfg.block_frames), dtype=torch.float32,
                     device=state.rx.chan_hist.device)

    def fn(params, state, iq):
        _, audio, spectra = frontend_step(cfg, params, state, iq)
        return audio, spectra[:, spectra.shape[1] - 1, :]

    return fn, (params, state, iq)


def _tone_blocks(if_hz, sample_rate: int, block_frames: int, n_blocks=2):
    """A carrier at every receiver IF and a noise floor, as ``n_blocks``
    contiguous ``[2, block_frames]`` float32 blocks (carries cross the
    boundary), made from a seed."""
    rng = np.random.default_rng(7)
    n = n_blocks * block_frames
    t = np.arange(n, dtype=np.float64) / sample_rate
    z = np.zeros(n, np.complex128)
    for f in sorted(set(if_hz)):
        z += 0.2 * np.exp(2j * np.pi * f * t)
    z += 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    planes = np.stack([z.real, z.imag]).astype(np.float32)
    return [planes[:, i * block_frames:(i + 1) * block_frames]
            for i in range(n_blocks)]


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the sharded steps over an ``n_devices``-position ``(time,
    chan)`` mesh of ``devices`` (None: every CUDA device, as the server's
    sharded engine; positions may repeat a device) and hold them to the
    single-device steps on the first position's device, over two carried
    blocks of a tone ensemble:

    * the direct and the channelized engine, sharded against single,
      under 3e-6 (FM slots under the branch-cut flip rule of PERF.md §2,
      here and below);
    * the fused time-major tail (``tail_kernel="pallas"``; kernel #1 per
      shard on the card, its plain version on the CPU), sharded against
      the single-device fused tail and the single-device fused tail
      against the plain tail, under 3e-6;
    * the u8exact filterbank law against the float32 product on 8-bit
      input, under 1e-5 of the product's peak.

    Raises AssertionError on a miss; returns the errors (``<name>`` off
    the FM slots, ``<name>_fm`` on them). Rates are the JAX dry run's
    (1.024 Msps, 128 k, 32 k)."""
    from .ops.channelizer import pfb_channelize_direct_tm, split_weights_u8
    from .parallel.mesh import make_mesh, mesh_shape_for, visible_devices
    from .parallel.sharded import ShardedFrontEnd
    from .parallel.sharded_channelized import ShardedChannelizedFrontEnd
    from .pipeline.channelized import (
        ChannelizedConfig,
        channelized_step,
        init_channelized_state,
        make_channelized_params,
    )

    devices = list(devices if devices is not None else visible_devices())
    dev = torch.device(devices[0])
    rates = dict(sample_rate=1_024_000, channel_rate=128_000,
                 audio_rate=32_000)
    num_channels = max(4, n_devices)
    cfg = ChainConfig(block_frames=512 * 2 * n_devices,
                      num_channels=num_channels, **rates)
    if n_devices % 2 == 0:
        # a 2-D mesh, so both the channel axis and the time halos run
        t, c = 2, n_devices // 2
    else:
        t, c = mesh_shape_for(n_devices, num_channels, cfg.block_frames,
                              cfg.fft_size)
    mesh = make_mesh(t, c, devices)
    if_hz = [(i % 8) * 10_000 for i in range(num_channels)]
    modes = [["FM", "AM", "USB", "LSB"][i % 4] for i in range(num_channels)]
    errors = {}

    def single(step, ccfg, params, state, blocks, **kw):
        out = []
        for b in blocks:
            state, audio, _ = step(ccfg, params, state,
                                   torch.from_numpy(b).to(dev), **kw)
            out.append(audio)
        return torch.cat(out, dim=-1)

    def sharded(fe, blocks):
        return torch.cat([fe.process(b)[0].full(dev) for b in blocks],
                         dim=-1)

    def check(name, got, ref, bound, mode, flip):
        """Every non-FM slot within ``bound``; an FM slot's sample beyond
        it only by a branch-cut flip of the FM law (PERF.md §2: at most
        two audio taps, on at most 1e-4 of the samples)."""
        err = (got - ref).abs()
        fm = mode.to(err.device) == 1
        strict = float(err[~fm].max())
        fm_err = err[fm]
        flips = int((fm_err > bound).sum())
        errors[name] = strict
        errors[name + "_fm"] = float(fm_err.max()) if fm.any() else 0.0
        if not float(ref.abs().max()) > 1e-2:
            raise AssertionError(f"{name}: the audio is (near) zero")
        if not strict < bound or flips > max(1, 1e-4 * fm_err.numel()) \
                or errors[name + "_fm"] > 2 * flip + bound:
            raise AssertionError(f"{name}: {strict:.2e} off FM, FM "
                                 f"{errors[name + '_fm']:.2e} ({flips} "
                                 f"above {bound})")
        return strict

    params = make_receiver_params(cfg, if_hz, 80_000, 8_000, modes,
                                  device=dev)
    blocks = _tone_blocks(if_hz, cfg.sample_rate, cfg.block_frames)
    got = sharded(ShardedFrontEnd(cfg, params, mesh), blocks)
    ref = single(frontend_step, cfg, params, init_state(cfg, dev), blocks)
    err = check("direct", got, ref, 3e-6, params.rx.mode,
                float(params.rx.audio_coeff.abs().max()))
    print(f"dryrun_multichip ok (direct): mesh(time={t}, chan={c}), audio "
          f"{tuple(got.shape)}, 2 carried blocks, max|sharded - single| = "
          f"{err:.2e} < 3e-6")

    # the channelized engine: each time shard holds the filterbank halo
    ccfg = ChannelizedConfig(
        block_frames=max(512 * 2 * n_devices, t * 2_560),
        num_channels=num_channels, **rates)
    cparams = make_channelized_params(ccfg, if_hz, 80_000, 8_000, modes,
                                      device=dev)
    cblocks = _tone_blocks(if_hz, ccfg.sample_rate, ccfg.block_frames)
    got = sharded(ShardedChannelizedFrontEnd(ccfg, cparams, mesh), cblocks)
    ref = single(channelized_step, ccfg, cparams,
                 init_channelized_state(ccfg, dev), cblocks)
    err = check("channelized", got, ref, 3e-6, cparams.mode,
                float(cparams.audio_coeff.abs().max()))
    print(f"dryrun_multichip ok (channelized): mesh(time={t}, chan={c}), "
          f"audio {tuple(got.shape)}, 2 carried blocks, max|sharded - "
          f"single| = {err:.2e} < 3e-6")

    # the fused tail per shard (c_local = 128, nd_local = 1,024: the
    # kernel rule holds on every shard), and the u8exact law
    pcfg = ChannelizedConfig(
        block_frames=16_384 * max(1, (t * 1024 * 8) // 16_384),
        num_channels=128 * c, tail_kernel="pallas", **rates)
    p_if = [(i % 8) * 10_000 for i in range(pcfg.num_channels)]
    p_modes = [["FM", "AM", "USB", "LSB"][i % 4]
               for i in range(pcfg.num_channels)]
    pparams = make_channelized_params(pcfg, p_if, 80_000, 8_000, p_modes,
                                      device=dev)
    pblocks = _tone_blocks(p_if, pcfg.sample_rate, pcfg.block_frames)
    got = sharded(ShardedChannelizedFrontEnd(pcfg, pparams, mesh), pblocks)
    fused = single(channelized_step, pcfg, pparams,
                   init_channelized_state(pcfg, dev), pblocks)
    xcfg = dataclasses.replace(pcfg, tail_kernel="xla")
    plain = single(channelized_step, xcfg, pparams,
                   init_channelized_state(xcfg, dev), pblocks)
    flip = float(pparams.audio_coeff.abs().max())
    fused_err = check("fused_vs_plain", fused, plain, 3e-6, pparams.mode,
                      flip)
    psh_err = check("sharded_fused_vs_single", got, fused, 3e-6,
                    pparams.mode, flip)

    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, (2, pcfg.block_frames)).astype(np.float32)
    u8 = torch.from_numpy((u8 - 128.0) / 128.0).to(dev)
    hist = torch.zeros((2, pcfg.proto_taps - 1), dtype=torch.float32,
                       device=dev)
    y_split, _, _ = pfb_channelize_direct_tm(
        u8, pparams.pfb_weights, pcfg.num_bins, hist, split=False,
        precision="u8exact",
        weights_split=split_weights_u8(pparams.pfb_weights.cpu()).to(dev))
    y_f32, _, _ = pfb_channelize_direct_tm(
        u8, pparams.pfb_weights, pcfg.num_bins, hist, split=False)
    u8_err = float((y_split - y_f32).abs().max() / y_f32.abs().max())
    errors["u8exact_rel"] = u8_err
    if not u8_err < 1e-5:
        raise AssertionError(f"u8exact filterbank law off: {u8_err:.2e}")
    print(f"dryrun_multichip ok (fused tail + u8exact): C="
          f"{pcfg.num_channels} fused-vs-plain {fused_err:.2e}, "
          f"sharded-vs-single {psh_err:.2e} (< 3e-6); u8exact-vs-f32 "
          f"filterbank {u8_err:.2e} rel (< 1e-5)")
    return errors
