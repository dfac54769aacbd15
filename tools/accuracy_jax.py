"""The JAX package's side of ``bench_torch.py --accuracy``: its
``channelized_step`` at each of the eleven (fir, pfb) pairs, on the CPU,
scored against the same float64 reference (``bench_torch.f64_reference``
on the port's parameters, the JAX package's value for value) on the same
three inputs, so that the port's SNRs on the card can be read beside the JAX
laws'.

    JAX_PLATFORMS=cpu python tools/accuracy_jax.py [C]

Off the TPU the JAX step computes "u8exact" at HIGHEST and "default" in
float32; here each filterbank tier is its explicit law, as
``tests/test_torch_tiers.py`` holds the port to it: u8exact
``pfb_channelize_direct_tm_u8``, default one bfloat16 pass with float32
sums, high ``_band_dot`` at HIGH, bf16 the default product stored as
bfloat16. The FIR tiers are what the JAX step computes on the CPU. Prints
one JSON line with ``bench_torch.py --accuracy``'s keys (C=128 unless
given).
"""

from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def explicit_law(tier):
    """A stand-in for the JAX step's ``_channelize_tm`` computing the
    tier's explicit law."""
    import jax.numpy as jnp
    from jax import lax

    from webradio_tpu.ops import channelizer as jchan
    from webradio_tpu.ops.pallas_tail_tm import _band_dot

    def channelize(cfg, params, pfb_hist, iq, split):
        if tier == "u8exact":
            return jchan.pfb_channelize_direct_tm_u8(
                iq, params.pfb_weights_split, cfg.num_bins, pfb_hist,
                split=split)
        f2, hist = jchan.pfb_frames_tm(iq, cfg.proto_taps, cfg.num_bins,
                                       pfb_hist)
        w2 = params.pfb_weights.reshape(params.pfb_weights.shape[0], -1)
        if tier == "highest":
            y = jnp.dot(f2, w2, precision=lax.Precision.HIGHEST,
                        preferred_element_type=jnp.float32)
        elif tier == "high":
            y = _band_dot(f2, w2, lax.Precision.HIGH)
        else:
            y = jnp.dot(f2.astype(jnp.bfloat16), w2.astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)
            if tier == "bf16":
                y = y.astype(jnp.bfloat16)
        c = cfg.num_channels
        return (y, y, hist) if not split else (y[:, :c], y[:, c:], hist)
    return channelize


def law_snrs(c: int, pairs) -> dict:
    """The JAX step's SNRs at the (fir, pfb) ``pairs``, C=``c``: a dict
    with ``bench_torch.py --accuracy``'s keys."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench_torch as bt
    from webradio_tpu.pipeline import channelized as jch
    from webradio_tpu_torch.pipeline import channelized as tch

    rx = bt.offset_ifs(c)
    cfg0 = tch.ChannelizedConfig(num_channels=c)
    params0 = tch.make_channelized_params(cfg0, rx, 80_000, 8_000, "FM",
                                          device="cpu")
    signals = bt.accuracy_signals(cfg0, rx)
    refs = {name: bt.f64_reference(cfg0, params0,
                                   sig.astype(np.float32).astype(np.float64))
            for name, sig in signals.items()}
    out = {}
    orig = jch._channelize_tm
    for fir, pfb in pairs:
        cfg = jch.ChannelizedConfig(num_channels=c, fir_precision=fir,
                                    pfb_precision=pfb)
        params = jch.make_channelized_params(cfg, rx, 80_000, 8_000, "FM")
        jch._channelize_tm = explicit_law(pfb)
        try:
            step = jax.jit(lambda x: jch.channelized_step(
                cfg, params, jch.init_channelized_state(cfg), x)[1])
            for name, sig in signals.items():
                got = np.asarray(step(jnp.asarray(sig.astype(np.float32))),
                                 np.float64)
                out[f"{name}_fir_{fir}_pfb_{pfb}"] = round(
                    bt.snr_db(refs[name], got), 1)
        finally:
            jch._channelize_tm = orig
    return out


def main(argv) -> int:
    import bench_torch as bt

    c = int(argv[1]) if len(argv) > 1 else bt.ACCURACY_C
    out = {"metric": "channelized_audio_snr_db_vs_float64", "channels": c,
           "device": "cpu", "package": "webradio_tpu (JAX), explicit laws",
           **law_snrs(c, bt.ACCURACY_PAIRS)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
