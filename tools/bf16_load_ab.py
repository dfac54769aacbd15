"""A/B of how kernel #1 (``fused_tail_audio_tm``) reads a bfloat16 packed
product, on a CUDA card (``webradio_tpu_torch``).

    python3 tools/bf16_load_ab.py

"vector" is ``csrc/tail_tm.cu`` as it stands: a lane loads 8 bytes (four
channels of one row) twice a plane and chunk, and the mix lane of each
value takes it by shuffle. "scalar" is the same source with those loads
replaced by one 2-byte load per value, in the float32 product's pattern
(built from a text substitution into a temporary directory). Both are timed
on the same bfloat16 product at C=1,024 and C=16,384 (nd=10,240), beside
the kernel on the float32 product of the same values, in turns (vector,
scalar, scalar, vector), and their outputs are compared (they compute the
same values, so they agree bit for bit). Needs a CUDA card.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VECTOR_LOAD = """    if constexpr (BF16_IN) {
      const auto* const pa = static_cast<const __nv_bfloat16*>(xa);
      const auto* const pb = static_cast<const __nv_bfloat16*>(xb);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const size_t at = (size_t)(n + 2 * (4 * j + (cm >> 2)) + hm) *
                              row_stride + cw + 4 * (cm & 3);
        rawi[j] = *reinterpret_cast<const uint2*>(pa + at);
        rawq[j] = *reinterpret_cast<const uint2*>(pb + at);
      }
    }"""
SCALAR_LOAD = """    if constexpr (BF16_IN) {
      const auto* const pa = static_cast<const unsigned short*>(xa);
      const auto* const pb = static_cast<const unsigned short*>(xb);
#pragma unroll
      for (int r = 0; r < HR; ++r) {
        const size_t at = (size_t)(n + 2 * r + hm) * row_stride + c_mix;
        cxi[r] = __uint_as_float(static_cast<uint32_t>(pa[at]) << 16);
        cxq[r] = __uint_as_float(static_cast<uint32_t>(pb[at]) << 16);
      }
    }"""
VECTOR_UNPACK = "      if constexpr (BF16_IN) unpack_rows();\n"


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    from webradio_tpu_torch.ops import _build, fir, firdesign, tail_tm

    src = (_build.CSRC_DIR / "tail_tm.cu").read_text()
    if VECTOR_LOAD not in src or VECTOR_UNPACK not in src:
        raise SystemExit("tail_tm.cu no longer holds the vector load")
    tmp = pathlib.Path(tempfile.mkdtemp())
    for h in _build.HEADERS:
        shutil.copy(h, tmp / h.name)
    alt = tmp / "tail_tm.cu"
    alt.write_text(src.replace(VECTOR_LOAD, SCALAR_LOAD).replace(
        VECTOR_UNPACK, ""))
    libs = {
        "vector": _build.load_library(),
        "scalar": _build.ctypes.CDLL(str(_build.build_library(
            sources=(alt, _build.CSRC_DIR / "tail.cu"),
            build_dir=tmp / "build",
            headers=tuple(tmp / h.name for h in _build.HEADERS)))),
    }
    ref_lib = libs["vector"]
    for name in ("webradio_tail_tm_launch", "webradio_tail_tm_error_string"):
        fn = getattr(libs["scalar"], name)
        fn.argtypes = getattr(ref_lib, name).argtypes
        fn.restype = getattr(ref_lib, name).restype

    dev = torch.device("cuda", 0)
    nd, d, k = 10_240, 5, 64
    w = torch.from_numpy(fir.toeplitz_weights(
        firdesign.design_lowpass_fir(80_000, 240_000), 1, 128)).to(dev)
    wa = torch.from_numpy(fir.toeplitz_weights(
        firdesign.design_lowpass_fir(8_000, 240_000), d, 32)).to(dev)
    rng = np.random.default_rng(5)
    out = {"device": torch.cuda.get_device_name(0)}
    busy = torch.ones(4096, 4096, device=dev)
    for c in (1_024, 16_384):
        prod = torch.from_numpy(rng.uniform(
            -0.5, 0.5, (nd, 2 * c)).astype(np.float32)).to(dev).bfloat16()
        z = lambda *s: torch.zeros(s, device=dev)
        args = (prod, prod, torch.zeros(c, dtype=torch.int64, device=dev),
                torch.from_numpy(rng.integers(0, 2**32, c)).to(dev), w, wa,
                d, torch.from_numpy((np.arange(c) % 4).astype(
                    np.int32)).to(dev), z(k - 1, c), z(k - 1, c), z(2, c),
                z(k - 1, c))
        f32 = (prod.float(), prod.float(), *args[2:])

        def run(lib_name, a=args):
            _build.load_library = lambda: libs[lib_name]
            return tail_tm.fused_tail_audio_tm(*a, packed=True, fast=True)

        def ms(fn, reps=20):
            fn()
            torch.cuda.synchronize()
            for _ in range(1 + reps // 8):
                busy @ busy
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(reps):
                fn()
            t1.record()
            t1.synchronize()
            return t0.elapsed_time(t1) / reps

        got = {n: run(n) for n in libs}
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(got["vector"],
                                                      got["scalar"]))
        turns = [(n, ms(lambda n=n: run(n))) for n in
                 ("vector", "scalar", "scalar", "vector")]
        f32_ms = ms(lambda: run("vector", f32))
        out[f"c{c}"] = {"turns_ms": turns, "float32_product_ms": f32_ms,
                        "bit_equal": equal}
        print(json.dumps({f"c{c}": out[f"c{c}"]}), flush=True)
    _build.load_library = lambda: ref_lib
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
