"""The port's live viewer (rmp_tpu_torch/utils/viewer.py) over HTTP on the
loopback address, tests/test_viewer.py's contract: a PNG frame, the state
as JSON after ticks ran, an orbit that changes the frame, pause freezing
the tick, reset and resume, a malformed camera body refused with 400."""
import json
import time
import urllib.error
import urllib.request as rq

import numpy as np
import torch

from rmp_tpu_torch import envs
from rmp_tpu_torch.utils.viewer import SimViewer, encode_png

torch.set_num_threads(1)


def post(url: str, data: bytes = b"") -> bytes:
    return rq.urlopen(rq.Request(url, data=data, method="POST"),
                      timeout=30).read()


def get_json(url: str) -> dict:
    return json.loads(rq.urlopen(url, timeout=30).read())


def test_viewer_http_roundtrip():
    rgb = np.arange(24 * 32 * 3, dtype=np.uint8).reshape(24, 32, 3)
    assert encode_png(rgb)[:8] == b"\x89PNG\r\n\x1a\n"
    v = SimViewer(envs.make("two_joint/01_target_rmp_only", device="cpu"),
                  port=0, width=128, height=96, realtime=False).start()
    try:
        host, port = v.address
        base = f"http://{host}:{port}"
        deadline = time.time() + 60
        while get_json(base + "/state")["tick"] == 0:
            assert time.time() < deadline, "the sim thread never stepped"
            time.sleep(0.1)
        frame = rq.urlopen(base + "/frame.png", timeout=60).read()
        assert frame[:8] == b"\x89PNG\r\n\x1a\n"
        st = get_json(base + "/state")
        assert st["tick"] > 0 and len(st["q"]) == 2
        assert st["device"] == "cpu"
        post(base + "/camera", json.dumps({"dyaw": 90.0}).encode())
        post(base + "/pause")
        time.sleep(0.5)
        assert rq.urlopen(base + "/frame.png", timeout=60).read() != frame
        t0 = get_json(base + "/state")["tick"]
        time.sleep(0.8)
        assert get_json(base + "/state")["tick"] == t0
        post(base + "/reset")
        assert get_json(base + "/state")["tick"] == 0
        post(base + "/resume")
        try:
            post(base + "/camera", b"nope")
            raise AssertionError("bad json accepted")
        except urllib.error.HTTPError as e:
            assert e.code == 400
    finally:
        v.stop()
