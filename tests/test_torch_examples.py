"""Every shipped example topology on the port's ``RadioApp``: the twin of
``tests/test_examples.py``.

Each ``examples/*.json`` goes through ``RadioApp(..., device="cpu")
.build()`` (tuners, chain configurations, parameters and receivers; no
device is opened) with the server on port 0 and a synthetic ``.cu8``
capture for file drivers. A topology either builds or raises the
``NotImplementedError`` that names its ROADMAP.md item; which one is listed
here, so a newly ported item (or a newly broken example) shows.
"""

import json
import pathlib

import numpy as np
import pytest

from webradio_tpu_torch.app import RadioApp
from webradio_tpu_torch.radio import Radio
from webradio_tpu_torch.web.audiostream import AudioStreamManager

EXAMPLES = sorted(
    (pathlib.Path(__file__).parent.parent / "examples").glob("*.json"))
#: the examples that raise, and the ROADMAP.md item their message names
#: (none: the multi-device examples build since the sharded engine came)
NOT_PORTED = {}


def _build(path, tmp_path):
    cfg = json.loads(path.read_text())
    cfg.setdefault("server", {})["port"] = 0
    for t in cfg.get("tuners", []):
        if t.get("driver") == "file":
            capture = tmp_path / "capture.cu8"
            capture.write_bytes(np.full(1 << 16, 128, np.uint8).tobytes())
            t["subdevice"] = str(capture)
    Radio.reset()
    AudioStreamManager.reset()
    return cfg, RadioApp(cfg, device="cpu")


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_example_topology_builds(path, tmp_path):
    cfg, app = _build(path, tmp_path)
    try:
        if path.name in NOT_PORTED:
            with pytest.raises(NotImplementedError,
                               match=NOT_PORTED[path.name]):
                app.build()
            return
        app.build()
        assert len(app.front_ends) == len(cfg["tuners"]), path.name
        assert len(app.receivers) == len(cfg.get("receivers", []))
        for t, fe in zip(cfg["tuners"], app.front_ends):
            assert fe.cfg.num_channels == t.get("capacity", 4)
            # hardware drivers default to the u8exact filterbank tier
            want = t.get("pfb_precision", "u8exact" if t.get("driver") in (
                "rtlsdr", "rtltcp") else "highest")
            assert fe.pfb_precision == want
            if fe.pipeline.cfg.__class__.__name__ == "ChannelizedConfig":
                assert fe.pipeline.cfg.pfb_precision == want
            if t.get("engine") == "sharded":
                # on the CPU the mesh is the CPU once
                assert type(fe.pipeline).__name__ == (
                    "ShardedChannelizedFrontEnd")
                assert fe.multihost == t.get("multihost", False)
    finally:
        app.close()
        Radio.reset()
        AudioStreamManager.reset()


def test_rtlsdr_usb_builds_with_its_pulse_sink_unbound(tmp_path, caplog,
                                                       monkeypatch):
    """``examples/rtlsdr_usb.json`` asks for local playback ("pulse").
    Where libpulse-simple is missing (this image, and servers) the topology
    builds, the receiver is left without a sink, with a warning, and the
    spec is kept for the checkpoint."""
    from webradio_tpu_torch.io import soundcard

    monkeypatch.setattr(soundcard, "_PA", None)
    _, app = _build(pathlib.Path(__file__).parent.parent / "examples"
                    / "rtlsdr_usb.json", tmp_path)
    try:
        with caplog.at_level("WARNING", logger="webradio_tpu_torch.app"):
            app.build()
        (rx,) = app.receivers
        assert rx.audio_sink is None and rx.audio_sink_spec == "pulse"
        assert "libpulse-simple not available" in caplog.text
        assert app.snapshot()["receivers"][0]["audio_sink"] == "pulse"
    finally:
        app.close()
        Radio.reset()
        AudioStreamManager.reset()


def test_headline_monitor_builds_at_u8exact(tmp_path):
    cfg, app = _build(pathlib.Path(__file__).parent.parent / "examples"
                      / "headline_monitor.json", tmp_path)
    try:
        app.build()
        (fe,) = app.front_ends
        assert fe.tuner.type == "rtlsdr"
        assert fe.pfb_precision == "u8exact"
        assert type(fe.pipeline).__name__ == "ChannelizedPipeline"
        p = fe.pipeline.params
        assert p.pfb_weights.shape[-1] == 69_632
        assert p.pfb_weights_split.shape == (2, 320, 2, 69_632)
        # the receiver sits in slot 0, every empty slot at the defaults, so
        # the slots share one FIR kernel: the main path (kernel #1)
        assert p.chan_toep is not None
    finally:
        app.close()
        Radio.reset()
        AudioStreamManager.reset()


def test_every_8bit_hardware_example_defaults_to_u8exact(tmp_path):
    seen = 0
    for path in EXAMPLES:
        cfg = json.loads(path.read_text())
        for t in cfg.get("tuners", []):
            if t.get("driver") in ("rtlsdr", "rtltcp") and (
                    path.name not in NOT_PORTED):
                _, app = _build(path, tmp_path)
                try:
                    app.build()
                    assert all(fe.pfb_precision == "u8exact"
                               for fe in app.front_ends)
                    seen += 1
                finally:
                    app.close()
                    Radio.reset()
                    AudioStreamManager.reset()
    assert seen >= 2  # headline_monitor (rtlsdr) and rtlsdr_fm (rtltcp)


def test_examples_exist():
    assert len(EXAMPLES) >= 8
