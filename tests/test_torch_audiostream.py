"""Audio fan-out on the port's own copy of the stream manager
(``webradio_tpu_torch/web/audiostream.py``): the counterparts of
``tests/test_audiostream.py``.

The reference pushes encoded blocks under one per-manager mutex with cheap
critical sections (src/web/audiostream.cxx:70-91). Here the registry lock
covers only the mountpoint lookup; each mount's encode and push run under
its own lock, so mounts never serialize on each other and a slow consumer
costs only its own mountpoint time.
"""

import threading
import time

import numpy as np

from webradio_tpu_torch.web.audiostream import (
    CONSUMER_DEPTH,
    AudioStreamManager,
)


def setup_function(_):
    AudioStreamManager.reset()


def teardown_function(_):
    AudioStreamManager.reset()


def test_fanout_stress_no_publish_stall():
    """32 consumers across 8 mounts, none of them reading: the pump's
    publish keeps returning promptly (backpressure drops, it never stalls:
    audiostream.cxx:135-137)."""
    audio = np.zeros(4800, np.float32)
    for m in range(8):
        for _ in range(4):
            AudioStreamManager.subscribe(f"m{m}", "wav", 48_000)
    t0 = time.perf_counter()
    for _ in range(CONSUMER_DEPTH + 4):
        for m in range(8):
            AudioStreamManager.publish(f"m{m}", audio, 48_000)
    dt = time.perf_counter() - t0
    # 96 publishes of 0.1 s of audio each; seconds would mean a stall
    assert dt < 5.0, f"publish stalled: {dt:.2f}s"
    stats = AudioStreamManager.stats()
    assert sum(s["dropped"] for s in stats.values()) > 0, (
        "full queues must drop, not block")


def test_publish_not_serialized_across_mounts():
    """A slow encode on one mount (its lock held) does not delay another
    mount's publish: the registry lock is never held during an encode."""
    AudioStreamManager.subscribe("aa", "wav", 48_000)
    b = AudioStreamManager.subscribe("bb", "wav", 48_000)
    b.read(timeout=1.0)  # the WAV header
    mount_a = AudioStreamManager._mounts["aa"]
    audio = np.zeros(480, np.float32)
    with mount_a.lock:  # a slow encode in progress on mount "aa"
        t0 = time.perf_counter()
        AudioStreamManager.publish("bb", audio, 48_000)
        assert time.perf_counter() - t0 < 0.5
        assert b.read(timeout=1.0), "bb consumer saw no data"


def test_concurrent_publish_and_subscribe_many_mounts():
    """Publish from one thread per mount while clients subscribe and
    unsubscribe: no deadlock, no exception, every consumer stream ends
    cleanly."""
    mounts = [f"s{m}" for m in range(8)]
    audio = np.zeros(480, np.float32)
    stop = threading.Event()
    errors = []

    def pump(name):
        try:
            while not stop.is_set():
                AudioStreamManager.publish(name, audio, 48_000)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def churn():
        try:
            for _ in range(50):
                subs = [AudioStreamManager.subscribe(m, "wav", 48_000)
                        for m in mounts]
                for s in subs:
                    s.read(timeout=0.01)
                for s in subs:
                    AudioStreamManager.unsubscribe(s)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    pumps = [threading.Thread(target=pump, args=(m,)) for m in mounts]
    churner = threading.Thread(target=churn)
    for t in pumps:
        t.start()
    churner.start()
    churner.join(timeout=30)
    stop.set()
    for t in pumps:
        t.join(timeout=5)
    assert not churner.is_alive(), "subscribe churn deadlocked"
    assert not errors, errors
