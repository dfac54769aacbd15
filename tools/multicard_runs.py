"""The sharded channelized engine over several real cards of one host, and
the multi-process step with NCCL, each process driving two cards: each on
CUDA graphs and with ``graph=False`` beside it.

    python3 tools/multicard_runs.py [out.json]
    python3 tools/multicard_runs.py --cpu   # a rehearsal on CPU positions

Needs four CUDA devices (exits 1 with fewer). In one process: the main
configuration (stock rates, C=16,384, every slot at 80 / 8 kHz, laws
cycling) on (time, chan) meshes (1, 4), (2, 2) and (4, 1) of cuda:0..3,
each over 8 tone-source blocks, on graphs (a graph a card and segment,
the peer copies between replays) and eagerly: its audio held to the
single-card ``ChannelizedPipeline`` on cuda:0 (3e-6, the FM flip rule of
PERF.md §2) and the graphs' to the eager stages' bit for bit, its
tail-kernel launches, its graph counts and its back-to-back ms/block
(host clock, every card synchronized at the end) beside the single
card's. Then two NCCL processes (this script with ``--worker``), each
driving two cards of a global (2, 2) mesh and ingesting its half of every
block, graph and eager: the audio of every seventh channel gathered across
both and held to the single-card step, each rank's back-to-back ms/block,
and a control blob three broadcast frames long. Prints one JSON line per
reading and writes them all to ``out.json`` when given.

``--cpu`` runs the same code on four CPU positions with gloo at C=1,024 (no
kernels, no graphs, no timing worth reading): a rehearsal of the control
flow only.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

CPU = "--cpu" in sys.argv
CHANNELS = 1_024 if CPU else chip_smoke.WIDE_CHANNELS
BLOCKS = 8
MESHES = ((1, 4), (2, 2), (4, 1))


def devices():
    return ["cpu"] * 4 if CPU else [f"cuda:{i}" for i in range(4)]


def sync_all():
    import torch

    if not CPU:
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def back_to_back(process, blocks, n=24) -> float:
    """ms/block of ``process(block)`` back to back after two warm blocks,
    every card synchronized at the end."""
    for b in blocks[:2]:
        process(b)
    sync_all()
    t0 = time.perf_counter()
    for i in range(n):
        process(blocks[i % len(blocks)])
    sync_all()
    return 1e3 * (time.perf_counter() - t0) / n


def setup(device):
    from webradio_tpu_torch.pipeline import channelized as ch

    cfg = ch.ChannelizedConfig(num_channels=CHANNELS,
                               block_frames=chip_smoke.BLOCK_FRAMES)
    ifs, modes = chip_smoke.slot_controls(CHANNELS)
    params = ch.make_channelized_params(cfg, ifs, 80_000, 8_000, modes,
                                        device=device)
    return cfg, params


def single_card(cfg, params, blocks):
    """The single-device step's audio ``[t, C]`` on the host, and its
    back-to-back ms/block."""
    import torch
    from webradio_tpu_torch.pipeline import channelized as ch

    pipe = ch.ChannelizedPipeline(cfg, params)
    # a graph replay rewrites its outputs two blocks on: keep copies
    outs = [chip_smoke.keep(pipe.process_host(b)) for b in blocks][1:] + [
        chip_smoke.keep(pipe.flush())]
    ref = torch.cat([a for a, _ in outs]).cpu()
    return ref, back_to_back(pipe.process_host, blocks)


def launches():
    return {name: fn.launches
            for name, fn in chip_smoke.tail_wrappers().items()}


def in_process(records):
    import torch
    from webradio_tpu_torch.parallel.mesh import make_mesh
    from webradio_tpu_torch.parallel.sharded_channelized import (
        ShardedChannelizedFrontEnd,
    )

    cfg, params = setup(devices()[0])
    blocks = chip_smoke.tone_blocks(BLOCKS, seed=13)
    ref, single_ms = single_card(cfg, params, blocks)
    fm = params.mode.cpu() == 1
    flip = float(params.audio_coeff.abs().max())
    records.append({"what": "single card", "device": devices()[0],
                    "channels": CHANNELS, "ms_per_block": single_ms})
    print(json.dumps(records[-1]), flush=True)
    for t, c in MESHES:
        mesh = make_mesh(t, c, devices())
        audio = {}
        for graph in (True, False):
            fe = ShardedChannelizedFrontEnd(cfg, params, mesh, graph=graph)
            chip_smoke.reset_counts()
            got = []
            for b in blocks + [None]:
                out = fe.process_host(b) if b is not None else fe.flush()
                if out is not None:  # joined now: a replay rewrites it
                    got.append(out[0].full(torch.device("cpu")).T)
            got = audio[graph] = torch.cat(got)
            counted = launches()
            err, flips, fm_max = chip_smoke.audio_mismatch(
                got, ref, fm, flip, chip_smoke.SHARDED_BOUND)
            records.append({
                "what": "one process", "mesh": [t, c], "graph": graph,
                "segmented": fe.segmented, "channels": CHANNELS,
                "launches": counted, "blocks": BLOCKS,
                "max_audio_err": err, "fm_max": fm_max, "fm_flips": flips,
                "peak": float(ref.abs().max()),
                "ms_per_block": back_to_back(fe.process_host, blocks),
                "graph_stats": fe.graph_stats(),
                "kernel_nodes_per_block": fe.graph_kernels_per_block()})
            if not graph:
                records[-1]["graph_bit_equal_to_eager"] = bool(
                    torch.equal(audio[True], audio[False]))
            print(json.dumps(records[-1]), flush=True)
            del fe


def worker(url: str, rank: int) -> None:
    """One of two ranks, driving two cards of a global (2, 2) mesh."""
    import torch
    from webradio_tpu_torch.parallel import multihost
    from webradio_tpu_torch.parallel.mesh import make_mesh
    from webradio_tpu_torch.parallel.sharded_channelized import (
        ShardedChannelizedFrontEnd,
    )

    mine = devices()[2 * rank:2 * rank + 2]
    if not CPU:
        os.environ["LOCAL_RANK"] = str(2 * rank)  # the rank's first card
    multihost.init_distributed(url, 2, rank,
                               backend="gloo" if CPU else "nccl")
    cfg, params = setup("cpu")
    mesh = make_mesh(2, 2, mine)
    lo, hi = multihost.host_time_slice(cfg.block_frames, mesh)
    blocks = chip_smoke.tone_blocks(4, seed=17)
    rows = list(range(0, CHANNELS, 7))  # every law (7 is prime to 4)
    _, ref_params = setup(mine[0])
    ref, _ = single_card(cfg, ref_params, blocks)
    ref = ref[:, rows]
    import numpy as np

    for graph in (True, False):
        fe = ShardedChannelizedFrontEnd(cfg, params, mesh, graph=graph)
        chip_smoke.reset_counts()
        got = []
        for b in blocks:
            audio, _ = fe.process(multihost.make_global_block(
                b[:, lo:hi], cfg.block_frames, mesh))
            got.append(multihost.gather_to_host(audio.fetch_rows(rows),
                                                dim=-1))
        counted = launches()
        got = torch.from_numpy(np.concatenate(got, axis=1)).T
        err, flips, fm_max = chip_smoke.audio_mismatch(
            got, ref, params.mode[rows] == 1,
            float(params.audio_coeff.abs().max()), chip_smoke.SHARDED_BOUND)
        ms = back_to_back(lambda b: fe.process_host(b[:, lo:hi]), blocks)
        blob = bytes(np.random.default_rng(3).integers(
            0, 256, 3 * multihost.CONTROL_BLOB_BYTES, np.uint8))
        same = multihost.broadcast_blob(blob if rank == 0 else None) == blob
        print("RANK " + json.dumps({
            "what": "two processes", "rank": rank, "devices": mine,
            "mesh": [2, 2], "graph": graph, "rows": [lo, hi],
            "channels": CHANNELS, "launches": counted, "max_audio_err": err,
            "fm_max": fm_max, "fm_flips": flips, "compared_rows": len(rows),
            "peak": float(ref.abs().max()), "ms_per_block": ms,
            "staged": fe.comm.staged, "graph_stats": fe.graph_stats(),
            "blob_3_frames_ok": same}), flush=True)
        del fe


def two_processes(records):
    url = f"file://{tempfile.mkdtemp(prefix='multicard_')}/rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", url, str(r)]
        + (["--cpu"] if CPU else []),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = chip_smoke.finish(procs, 600)
    for r, (p, text) in enumerate(zip(procs, outs)):
        lines = [ln for ln in text.splitlines() if ln.startswith("RANK ")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"rank {r}: rc {p.returncode}\n"
                                 f"{text[-3000:]}")
        for ln in lines:
            records.append(json.loads(ln.split(" ", 1)[1]))
            print(json.dumps(records[-1]), flush=True)


def main(argv) -> int:
    import torch

    if "--worker" in argv:
        i = argv.index("--worker")
        worker(argv[i + 1], int(argv[i + 2]))
        return 0
    if not CPU and torch.cuda.device_count() < 4:
        print("multicard_runs: needs four CUDA devices", file=sys.stderr)
        return 1
    if not CPU:
        from webradio_tpu_torch.ops import _build

        _build.build_library()
        _build.load_library()
        print(chip_smoke.nvidia_smi("name,power.limit"), flush=True)
    records = []
    in_process(records)
    two_processes(records)
    out = [a for a in argv[1:] if not a.startswith("--")]
    if out:
        pathlib.Path(out[0]).write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
