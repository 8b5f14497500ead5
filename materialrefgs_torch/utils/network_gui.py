"""SIBR remote-viewer socket protocol (reference
gaussian_renderer/network_gui.py; wired but commented out in the reference
trainers, train_refnerf.py:1831).

Protocol: length-prefixed JSON camera messages in, raw RGB bytes + verify
string + JSON metrics out. Cameras arrive as OpenGL-style view matrices with
flipped y/z columns, converted to the port's Camera via make_minicam on the
GUI's device (the card unless device="cpu"). The JAX package's
utils/network_gui.py, ported.
"""
from __future__ import annotations

import json
import socket
import struct

import numpy as np

from materialrefgs_torch.cameras import make_minicam


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009, device=None):
        self.device = device
        self.host = host
        self.port = port
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn = None

    def _send_json(self, data):
        raw = json.dumps(data).encode("utf-8")
        self.conn.sendall(struct.pack("I", len(raw)))
        self.conn.sendall(raw)

    def try_connect(self, render_items: list[str]):
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
            self._send_json(render_items)
            return True
        except (BlockingIOError, OSError):
            return False

    def _read(self):
        # TCP recv may return short; accumulate the 4-byte length prefix
        # (a partial prefix would otherwise decode as a bogus length and
        # surface as a JSONDecodeError the trainer's handlers don't catch).
        hdr = b""
        while len(hdr) < 4:
            chunk = self.conn.recv(4 - len(hdr))
            if not chunk:
                raise ConnectionError("client closed")
            hdr += chunk
        n = int.from_bytes(hdr, "little")
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("client closed")
            buf += chunk
        return json.loads(buf.decode("utf-8"))

    def receive(self):
        """-> (Camera | None, do_training, keep_alive, scaling_modifier,
        render_mode)."""
        msg = self._read()
        width, height = msg["resolution_x"], msg["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None, None
        wv = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
        wv[:, 1] *= -1
        wv[:, 2] *= -1
        fp = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        fp[:, 1] *= -1
        cam = make_minicam(
            width, height, msg["fov_y"], msg["fov_x"], wv, fp,
            znear=msg["z_near"], zfar=msg["z_far"], device=self.device,
        )
        return (
            cam,
            bool(msg["train"]),
            bool(msg["keep_alive"]),
            msg["scaling_modifier"],
            msg.get("render_mode", "RGB"),
        )

    def send(self, image: np.ndarray | None, verify: str, metrics: dict):
        """image: (H, W, 3) float in [0,1] or None."""
        if image is not None:
            if hasattr(image, "detach"):
                image = image.detach().cpu().numpy()
            raw = (np.clip(np.asarray(image), 0, 1) * 255).astype(np.uint8)
            self.conn.sendall(raw.tobytes())
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))
        self._send_json(metrics)

    def close(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None
