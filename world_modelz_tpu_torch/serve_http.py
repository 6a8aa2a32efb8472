"""HTTP front end for the batched rollout service.

Port of ``world_modelz_tpu.serve_http``, a copy of its stdlib front end
(the port imports nothing of the JAX package): the same routes, error
codes and wire bytes, so either package's client talks to either
package's server. The reference has no serving network layer (its closest
analog is the interactive eval loop, minecraft/main2.py:59-131);
``RolloutService`` (``serve.py``) batches, and this module puts a wire
protocol on it. Pure stdlib (``http.server``) and numpy: the service does
the heavy lifting, the front end parses requests and moves bytes.

Wire protocol (HTTP/1.1, localhost-oriented):

  GET  /healthz                      -> {"ok": true}
  GET  /stats                        -> RolloutService.stats + open sessions
  POST /v1/generate                  body: .npy  (S, H, W, C) float  seed
                                     -> .npy (T, H, W, C) generated pixels
  POST /v1/sessions                  body: .npy seed clip
                                     -> {"session_id": n}   (encoded ONCE)
  POST /v1/sessions/<id>/generate    -> .npy next (T, H, W, C) segment
  DELETE /v1/sessions/<id>           -> {"closed": n}

Arrays travel as raw .npy bytes (``application/x-npy``). Concurrent POSTs
are coalesced into one device batch by the service's worker: the HTTP
layer is threaded so that simultaneous requests land in one batch.
Errors: 400 (bad body, rank or ``X-Timeout-S``), 401 (bearer token), 404
(path or session), 409 (a session's generate() already in flight), 413
(body above ``MAX_BODY_BYTES``), 503 (expired in the queue, or the rollout
failed).
"""

from __future__ import annotations

import io
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

NPY_CONTENT_TYPE = "application/x-npy"
_SESSION_RE = re.compile(r"^/v1/sessions/(\d+)(/generate)?$")

# refuse request bodies above this size (a seed clip at production scale
# is ~ 6 * 256 * 256 * 3 * 4B = 4.7 MB; 64 MB leaves generous headroom)
MAX_BODY_BYTES = 64 * 1024 * 1024


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()


def _npy_parse(body: bytes) -> np.ndarray:
    return np.load(io.BytesIO(body), allow_pickle=False)


class RolloutHTTPServer:
    """Threaded HTTP server wrapping a `RolloutService`.

    `port=0` binds an ephemeral port (read `.port` after construction).
    `start()` serves in a daemon thread; `shutdown()` stops the listener
    and closes every open session (the service itself is NOT closed — the
    caller owns its lifecycle).

    `auth_token` (optional) requires `Authorization: Bearer <token>` on
    every route except /healthz (load-balancer probes); requests without
    it get 401. Tokens ride plaintext HTTP — pair with a TLS-terminating
    reverse proxy before leaving localhost.
    """

    def __init__(
        self,
        service,
        host: str = "127.0.0.1",
        port: int = 0,
        auth_token: str = "",
    ):
        self.service = service
        self.auth_token = auth_token
        self._sessions: dict = {}
        self._lock = threading.Lock()
        self._next_id = 0
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.frontend = self  # type: ignore[attr-defined]
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "RolloutHTTPServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self):
        self._httpd.serve_forever()

    def shutdown(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join()
        with self._lock:
            self._sessions.clear()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()

    # ------------------------------------------------------------- sessions

    def _open_session(self, seed: np.ndarray) -> int:
        sess = self.service.open_session(seed)
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            self._sessions[sid] = sess
        return sid

    def _get_session(self, sid: int):
        with self._lock:
            return self._sessions.get(sid)

    def _close_session(self, sid: int) -> bool:
        with self._lock:
            return self._sessions.pop(sid, None) is not None


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # -------------------------------------------------------------- helpers

    @property
    def fe(self) -> RolloutHTTPServer:
        return self.server.frontend  # type: ignore[attr-defined]

    def log_message(self, *args):  # quiet by default; stats carry the info
        pass

    def _authorized(self) -> bool:
        """Bearer-token check (when the server has one configured).
        /healthz stays open for liveness probes."""
        import hmac

        token = self.fe.auth_token
        if not token or self.path == "/healthz":
            return True
        got = self.headers.get("Authorization", "")
        if got.startswith("Bearer ") and hmac.compare_digest(
            got[len("Bearer "):], token
        ):
            return True
        self._drain_body()
        self._error(401, "missing or invalid Authorization bearer token")
        return False

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def _npy(self, arr: np.ndarray) -> None:
        self._send(200, _npy_bytes(arr), NPY_CONTENT_TYPE)

    def _error(self, code: int, msg: str) -> None:
        self._json(code, {"error": msg})

    def _drain_body(self) -> None:
        """Consume an unread request body before responding on an error
        path. HTTP/1.1 keep-alive reuses the connection: leftover body
        bytes would be parsed as the NEXT request line, poisoning every
        later request on the socket. Oversized or chunked bodies are not
        worth draining — mark the connection for close instead."""
        if self.headers.get("Transfer-Encoding"):
            self.close_connection = True
            return
        n = int(self.headers.get("Content-Length", 0))
        if n <= 0:
            return
        if n > MAX_BODY_BYTES:
            self.close_connection = True
            return
        while n > 0:
            chunk = self.rfile.read(min(n, 1 << 20))
            if not chunk:
                self.close_connection = True
                return
            n -= len(chunk)

    def _read_array(self) -> Optional[np.ndarray]:
        if self.headers.get("Transfer-Encoding"):
            self.close_connection = True
            self._error(400, "chunked bodies unsupported; send "
                             "Content-Length")
            return None
        n = int(self.headers.get("Content-Length", 0))
        if n <= 0:
            self._error(400, "missing request body")
            return None
        if n > MAX_BODY_BYTES:
            # not draining 64+ MB of junk; the response says close
            self.close_connection = True
            self._error(413, f"body exceeds {MAX_BODY_BYTES} bytes")
            return None
        body = self.rfile.read(n)
        try:
            arr = _npy_parse(body)
        except Exception as e:
            self._error(400, f"body is not a valid .npy array: {e}")
            return None
        if arr.ndim != 4:
            self._error(
                400, f"seed clip must be (S, H, W, C), got shape {arr.shape}"
            )
            return None
        return arr

    # --------------------------------------------------------------- routes

    def do_GET(self):
        if not self._authorized():
            return
        self._drain_body()
        if self.path == "/healthz":
            return self._json(200, {"ok": True})
        if self.path == "/stats":
            fe = self.fe
            with fe._lock:
                n_sessions = len(fe._sessions)
            return self._json(
                200, dict(fe.service.stats, open_sessions=n_sessions)
            )
        return self._error(404, f"unknown path {self.path}")

    def do_POST(self):
        if not self._authorized():
            return
        if self.path == "/v1/generate":
            seed = self._read_array()
            if seed is None:
                return
            # optional queue deadline (seconds): under overload the
            # service sheds the request instead of serving it late
            timeout_s = None
            hdr = self.headers.get("X-Timeout-S")
            if hdr:
                try:
                    timeout_s = float(hdr)
                except ValueError:
                    return self._error(400, f"bad X-Timeout-S: {hdr!r}")
            try:
                out = self.fe.service.submit(seed, timeout_s).result()
            except TimeoutError:
                return self._error(
                    503, "request expired in queue (X-Timeout-S deadline)"
                )
            except Exception as e:
                return self._error(503, f"rollout failed: {e}")
            return self._npy(out)

        if self.path == "/v1/sessions":
            seed = self._read_array()
            if seed is None:
                return
            try:
                sid = self.fe._open_session(seed)
            except Exception as e:
                return self._error(503, f"session open failed: {e}")
            return self._json(200, {"session_id": sid})

        # the remaining POST routes carry no body; drain anything a
        # client sent anyway so keep-alive stays usable after the reply
        self._drain_body()

        m = _SESSION_RE.match(self.path)
        if m and m.group(2):
            sess = self.fe._get_session(int(m.group(1)))
            if sess is None:
                return self._error(404, f"no session {m.group(1)}")
            try:
                out = sess.generate()
            except RuntimeError as e:  # generate() already in flight
                return self._error(409, str(e))
            except Exception as e:
                return self._error(503, f"rollout failed: {e}")
            return self._npy(out)

        return self._error(404, f"unknown path {self.path}")

    def do_DELETE(self):
        if not self._authorized():
            return
        self._drain_body()
        m = _SESSION_RE.match(self.path)
        if m and not m.group(2):
            sid = int(m.group(1))
            if self.fe._close_session(sid):
                return self._json(200, {"closed": sid})
            return self._error(404, f"no session {sid}")
        return self._error(404, f"unknown path {self.path}")


# ---------------------------------------------------------------------------
# Minimal stdlib client (also the reference implementation of the protocol)
# ---------------------------------------------------------------------------


def _request(
    url: str, method: str = "GET", body: Optional[bytes] = None,
    ctype: Optional[str] = None, timeout: float = 600.0,
    headers: Optional[dict] = None,
):
    import urllib.request

    req = urllib.request.Request(url, data=body, method=method)
    if ctype:
        req.add_header("Content-Type", ctype)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        payload = resp.read()
        if resp.headers.get("Content-Type") == NPY_CONTENT_TYPE:
            return _npy_parse(payload)
        return json.loads(payload)


def http_generate(
    base_url: str, seed_clip: np.ndarray, timeout: float = 600.0,
    queue_timeout_s: Optional[float] = None, token: str = "",
) -> np.ndarray:
    """One-shot generate against a running front-end.

    `queue_timeout_s` sets the server-side queue deadline (X-Timeout-S);
    an expired request gets a 503 instead of a late result. `token` is
    the server's bearer auth token (when it has one configured).
    """
    headers = {}
    if queue_timeout_s is not None:
        headers["X-Timeout-S"] = str(queue_timeout_s)
    if token:
        headers["Authorization"] = f"Bearer {token}"
    return _request(
        f"{base_url}/v1/generate", "POST", _npy_bytes(seed_clip),
        NPY_CONTENT_TYPE, timeout, headers=headers or None,
    )


class HTTPSession:
    """Client-side handle for a streaming session."""

    def __init__(self, base_url: str, seed_clip: np.ndarray,
                 timeout: float = 600.0, token: str = ""):
        self._base = base_url
        self._timeout = timeout
        self._headers = (
            {"Authorization": f"Bearer {token}"} if token else None
        )
        resp = _request(
            f"{base_url}/v1/sessions", "POST", _npy_bytes(seed_clip),
            NPY_CONTENT_TYPE, timeout, headers=self._headers,
        )
        self.session_id = resp["session_id"]

    def generate(self) -> np.ndarray:
        return _request(
            f"{self._base}/v1/sessions/{self.session_id}/generate",
            "POST", b"", None, self._timeout, headers=self._headers,
        )

    def close(self):
        _request(
            f"{self._base}/v1/sessions/{self.session_id}", "DELETE",
            timeout=self._timeout, headers=self._headers,
        )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
