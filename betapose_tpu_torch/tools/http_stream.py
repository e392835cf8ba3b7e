"""MJPEG-over-HTTP detection stream — parity with darknet's http_stream
(`train_YOLO/src/http_stream.cpp:120-205`, served by the demo verb's
`-http_port` flag, `detector.c:1230,1295`).

The reference's MJPGWriter is a select()-driven single-socket loop: each
`write(frame)` call accepts any pending clients on the master socket (and
greets them with the multipart/x-mixed-replace header) then pushes the
JPEG-encoded frame to every connected client, dropping clients whose
sockets fail mid-write.  This module reproduces that design — the demo
loop drives the server; there is no server thread — including the exact
boundary token ("mjpegstream") and part headers (`http_stream.cpp:175,182`)
so stock MJPEG viewers (browsers, VLC, ffplay) work unchanged.

A copy of the JAX package's `tools/http_stream` (it uses no framework).
"""

from __future__ import annotations

import select
import socket
import time


_MAIN_HEADER = (
    b"HTTP/1.0 200 OK\r\n"
    b"Server: betapose-tpu\r\n"
    b"Connection: close\r\n"
    b"Max-Age: 0\r\n"
    b"Expires: 0\r\n"
    b"Cache-Control: no-cache, private\r\n"
    b"Pragma: no-cache\r\n"
    b"Content-Type: multipart/x-mixed-replace; boundary=mjpegstream\r\n"
    b"\r\n"
)


class MjpegStreamer:
    """Select-driven MJPEG push server (reference MJPGWriter semantics).

    write_rgb(frame) accepts pending clients and sends them the frame;
    clients connected between writes receive the next frame (same as the
    reference — a client sees only frames written after it connected)."""

    def __init__(self, port: int, quality: int = 80):
        self.quality = int(quality)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("0.0.0.0", int(port)))
        self._srv.listen(8)
        self._srv.setblocking(False)
        self._clients: list[socket.socket] = []

    @property
    def port(self) -> int:
        return self._srv.getsockname()[1]

    def _accept_pending(self):
        while True:
            r, _, _ = select.select([self._srv], [], [], 0)
            if not r:
                return
            try:
                client, _ = self._srv.accept()
            except OSError:
                return
            # clients stay NON-blocking for their whole life: a stalled
            # viewer (full TCP window) must never block the demo loop —
            # the reference select()s for writability and drops slow
            # clients (http_stream.cpp:155-182)
            client.setblocking(False)
            try:
                # drain whatever request bytes arrived; the stream is
                # push-only
                client.recv(4096)
            except OSError:
                pass
            if self._send_bounded(client, _MAIN_HEADER):
                self._clients.append(client)
            else:
                try:
                    client.close()
                except OSError:
                    pass

    @staticmethod
    def _send_bounded(c, data: bytes, deadline_s: float = 0.25) -> bool:
        """Send on a non-blocking socket, waiting for writability up to
        deadline_s total.  Returns False (drop the client) on timeout or
        socket error."""
        view = memoryview(data)
        end = time.monotonic() + deadline_s
        while view:
            try:
                n = c.send(view)
                view = view[n:]
            except (BlockingIOError, InterruptedError):
                left = end - time.monotonic()
                if left <= 0:
                    return False
                _, w, _ = select.select([], [c], [], left)
                if not w:
                    return False
            except OSError:
                return False
        return True

    def write_jpeg(self, jpg: bytes):
        """Push one already-encoded JPEG to all clients (accepting any
        pending connections first, `http_stream.cpp:155-182`).  Clients
        that cannot take the frame within the send deadline are dropped,
        like the reference's failed-write drop."""
        self._accept_pending()
        part = (b"--mjpegstream\r\nContent-Type: image/jpeg\r\n"
                + f"Content-Length: {len(jpg)}\r\n\r\n".encode()
                + jpg + b"\r\n")
        alive = []
        for c in self._clients:
            if self._send_bounded(c, part):
                alive.append(c)
            else:
                try:
                    c.close()
                except OSError:
                    pass
        self._clients = alive

    def write_rgb(self, frame_rgb):
        """JPEG-encode an RGB uint8 frame and push it."""
        import cv2

        ok, buf = cv2.imencode(
            ".jpg", frame_rgb[..., ::-1],
            [int(cv2.IMWRITE_JPEG_QUALITY), self.quality])
        if not ok:
            raise RuntimeError("JPEG encode failed")
        self.write_jpeg(buf.tobytes())

    def close(self):
        for c in self._clients:
            try:
                c.close()
            except OSError:
                pass
        self._clients = []
        self._srv.close()
