"""Port parity: the HTTP front end (``world_modelz_tpu_torch.serve_http``).

The JAX package's front-end tests (tests/test_serve_http.py) run against
the port's server over a CPU ``RolloutService``: healthz and stats, round
trip, concurrent coalescing, sessions, error paths, the queue deadline and
bearer auth. The wire protocol is held both ways: JAX's client against the
port's server, and the port's client against JAX's server, each giving the
arrays of the other package's client on the same service (its sampler
reseeded before each request, so the two requests draw the same numbers).
Ephemeral ports only; every server and service thread is joined.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from world_modelz_tpu import serve_http as jhttp  # noqa: E402
from world_modelz_tpu.models import VQAutoEncoder as JaxTokenizer  # noqa: E402
from world_modelz_tpu.models.video import (  # noqa: E402
    VqVideoDiffusionModel as JaxDenoiser,
)
from world_modelz_tpu.serve import RolloutService as JaxService  # noqa: E402
from world_modelz_tpu_torch import serve_http as phttp  # noqa: E402
from world_modelz_tpu_torch.models import (  # noqa: E402
    VQAutoEncoder,
    VqVideoDiffusionModel,
)
from world_modelz_tpu_torch.serve import RolloutService  # noqa: E402
from world_modelz_tpu_torch.serve_http import (  # noqa: E402
    HTTPSession,
    RolloutHTTPServer,
    http_generate,
)

S, IMG, C, K, D = 3, 16, 1, 16, 8
TH = IMG // 4
TOKEN = "s3cret"


@pytest.fixture(scope="module")
def server():
    torch.manual_seed(0)
    tok = VQAutoEncoder(D, K, 2, 8, C, device="cpu")
    model = VqVideoDiffusionModel(
        (S, TH, TH), 16, K, (1, 1, 1), 1, 8, 16, heads=2, device="cpu")
    svc = RolloutService(tok, model, num_frames=2, num_iterations=2,
                         batch_size=4, max_wait_s=0.05, device="cpu")
    try:
        with RolloutHTTPServer(svc, port=0) as srv:
            yield srv
    finally:
        svc.close()


def _url(server):
    return f"http://127.0.0.1:{server.port}"


def _clip(seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(S, IMG, IMG, C)).astype(np.float32)


def test_http_healthz_and_stats(server):
    with urllib.request.urlopen(f"{_url(server)}/healthz", timeout=30) as r:
        assert json.loads(r.read()) == {"ok": True}
    with urllib.request.urlopen(f"{_url(server)}/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert set(server.service.stats) | {"open_sessions"} == set(stats)


def test_http_generate_roundtrip(server):
    out = http_generate(_url(server), _clip(), timeout=300)
    assert out.shape == (2, IMG, IMG, C)
    assert out.dtype == np.float32
    assert np.isfinite(out).all()


def test_http_concurrent_requests_coalesce(server):
    """Simultaneous HTTP clients land in one batch."""
    before = dict(server.service.stats)
    outs = [None] * 3

    def call(i):
        outs[i] = http_generate(_url(server), _clip(i), timeout=300)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for out in outs:
        assert out.shape == (2, IMG, IMG, C)
    d_req = server.service.stats["requests"] - before["requests"]
    d_bat = server.service.stats["batches"] - before["batches"]
    assert d_req == 3
    assert d_bat < 3  # at least two requests shared a batch


def test_http_session_flow(server):
    with HTTPSession(_url(server), _clip(7), timeout=300) as sess:
        a = sess.generate()
        b = sess.generate()
        assert a.shape == (2, IMG, IMG, C) and b.shape == (2, IMG, IMG, C)
        with urllib.request.urlopen(f"{_url(server)}/stats", timeout=30) as r:
            assert json.loads(r.read())["open_sessions"] >= 1
    # closed: further generates 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(
            urllib.request.Request(
                f"{_url(server)}/v1/sessions/{sess.session_id}/generate",
                data=b"", method="POST",
            ),
            timeout=30,
        )
    assert ei.value.code == 404


def _status(req):
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    return ei.value.code, json.loads(ei.value.read())


def test_http_error_paths(server):
    url = _url(server)
    # invalid body -> 400
    code, _ = _status(urllib.request.Request(
        f"{url}/v1/generate", data=b"not-an-npy", method="POST"))
    assert code == 400
    # wrong rank -> 400
    buf = io.BytesIO()
    np.save(buf, np.zeros((3, 3), np.float32))
    code, body = _status(urllib.request.Request(
        f"{url}/v1/generate", data=buf.getvalue(), method="POST"))
    assert code == 400 and "(S, H, W, C)" in body["error"]
    # no body -> 400
    code, _ = _status(urllib.request.Request(
        f"{url}/v1/sessions", data=b"", method="POST"))
    assert code == 400
    # above MAX_BODY_BYTES -> 413 (the body is not read)
    req = urllib.request.Request(f"{url}/v1/generate", data=b"x", method="POST")
    req.add_header("Content-Length", str(phttp.MAX_BODY_BYTES + 1))
    code, _ = _status(req)
    assert code == 413
    # unknown path -> 404
    code, _ = _status(f"{url}/nope")
    assert code == 404
    # unknown session -> 404
    code, _ = _status(urllib.request.Request(
        f"{url}/v1/sessions/99999", method="DELETE"))
    assert code == 404
    # a session's second generate() while one is in flight -> 409
    sid = json.loads(urllib.request.urlopen(urllib.request.Request(
        f"{url}/v1/sessions", data=phttp._npy_bytes(_clip(3)), method="POST"),
        timeout=60).read())["session_id"]
    sess = server._get_session(sid)
    with server.service._programs:  # the worker waits to run the rollout
        first = sess.generate_async()
        code, body = _status(urllib.request.Request(
            f"{url}/v1/sessions/{sid}/generate", data=b"", method="POST"))
    assert code == 409 and "in flight" in body["error"]
    assert first.result(timeout=60).shape == (2, IMG, IMG, C)
    server._close_session(sid)


def test_http_queue_timeout(server):
    # generous deadline: request completes normally
    out = http_generate(_url(server), _clip(5), timeout=300,
                        queue_timeout_s=600.0)
    assert out.shape == (2, IMG, IMG, C)
    # malformed header (valid body) -> 400 naming the header
    code, body = _status(urllib.request.Request(
        f"{_url(server)}/v1/generate", data=phttp._npy_bytes(_clip(6)),
        method="POST", headers={"X-Timeout-S": "soon"}))
    assert code == 400 and "X-Timeout-S" in body["error"]
    # a deadline already past -> 503
    code, body = _status(urllib.request.Request(
        f"{_url(server)}/v1/generate", data=phttp._npy_bytes(_clip(6)),
        method="POST", headers={"X-Timeout-S": "-1"}))
    assert code == 503 and "expired" in body["error"]


def test_http_bearer_auth(server):
    """A token-protected front end: 401 without or with a wrong token,
    healthz stays open, the client helpers attach the header."""
    with RolloutHTTPServer(server.service, port=0, auth_token=TOKEN) as srv:
        url = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True}
        code, _ = _status(f"{url}/stats")
        assert code == 401
        code, _ = _status(urllib.request.Request(
            f"{url}/stats", headers={"Authorization": "Bearer nope"}))
        assert code == 401
        # a refused POST's body is drained: the next request parses
        code, _ = _status(urllib.request.Request(
            f"{url}/v1/generate", data=phttp._npy_bytes(_clip(1)), method="POST"))
        assert code == 401
        out = http_generate(url, _clip(7), timeout=300, token=TOKEN)
        assert out.shape == (2, IMG, IMG, C)
        sess = HTTPSession(url, _clip(8), timeout=300, token=TOKEN)
        assert sess.generate().shape == (2, IMG, IMG, C)
        sess.close()


def _client_runs(url, reseed, generate, session_cls, token):
    """One generate and one two-segment session through a client, each
    from a reseeded sampler."""
    reseed()
    one = generate(url, _clip(11), timeout=300, token=token)
    reseed()
    with session_cls(url, _clip(12), timeout=300, token=token) as sess:
        segs = [sess.generate(), sess.generate()]
    return [one, *segs]


def _same_arrays(a, b):
    for x, y in zip(a, b, strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_jax_client_against_port_server(server):
    svc = server.service
    with RolloutHTTPServer(svc, port=0, auth_token=TOKEN) as srv:
        url = f"http://127.0.0.1:{srv.port}"

        def reseed():
            svc._generator.manual_seed(21)

        mine = _client_runs(url, reseed, http_generate, HTTPSession, TOKEN)
        theirs = _client_runs(url, reseed, jhttp.http_generate,
                              jhttp.HTTPSession, TOKEN)
        with pytest.raises(urllib.error.HTTPError) as ei:
            jhttp.http_generate(url, _clip(1), timeout=30)
        assert ei.value.code == 401
    _same_arrays(mine, theirs)
    assert mine[0].shape == (2, IMG, IMG, C)


@pytest.fixture(scope="module")
def jax_server():
    jtok = JaxTokenizer(embedding_dim=D, num_embeddings=K, downscale_steps=2,
                        hidden_planes=8, in_channels=C)
    key = jax.random.PRNGKey(0)
    tok_state = jax.jit(jtok.init)(key, jnp.zeros((1, IMG, IMG, C)))
    jm = JaxDenoiser(data_shape=(S, TH, TH), dim=16, num_classes=K,
                     extents=(1, 1, 1), depth=1, dim_head=8, mlp_dim=16,
                     heads=2, backend="xla")
    params = jax.jit(jm.init)(key, jnp.zeros((1, S, TH, TH), jnp.int32))["params"]
    svc = JaxService(jtok, tok_state, jm, params, num_frames=2,
                     num_iterations=2, batch_size=4, max_wait_s=0.05)
    try:
        with jhttp.RolloutHTTPServer(svc, port=0, auth_token=TOKEN) as srv:
            yield srv
    finally:
        svc.close()


def test_port_client_against_jax_server(jax_server):
    url = f"http://127.0.0.1:{jax_server.port}"
    svc = jax_server.service

    def reseed():
        svc._key = jax.random.PRNGKey(5)

    mine = _client_runs(url, reseed, http_generate, HTTPSession, TOKEN)
    theirs = _client_runs(url, reseed, jhttp.http_generate,
                          jhttp.HTTPSession, TOKEN)
    _same_arrays(mine, theirs)
    assert mine[0].shape == (2, IMG, IMG, C) and np.isfinite(mine[0]).all()
    assert phttp._request(f"{url}/healthz") == {"ok": True}
    stats = phttp._request(f"{url}/stats", headers={"Authorization": f"Bearer {TOKEN}"})
    assert stats["open_sessions"] == 0 and stats["requests"] >= 6
    with pytest.raises(urllib.error.HTTPError) as ei:
        http_generate(url, _clip(1), timeout=30)
    assert ei.value.code == 401
