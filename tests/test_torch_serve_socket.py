"""The port's TCP serve transport on the CPU, driven through the port's
``ServeClient``: concurrent clients, in-band errors, ``--max-requests``,
push and poll hot reload, and the reload refusals with the JAX package's
messages. The server runs in a thread of the test process, bounded by
``max_requests``; every wait has a deadline."""

import base64
import contextlib
import dataclasses
import json
import os
import shutil
import threading
import time

import pytest

from musicvae_tpu_torch import cli
from musicvae_tpu_torch.checkpoints import io as ckpt_io
from musicvae_tpu_torch.client import ServeClient, ServeError
from musicvae_tpu_torch.config import GenSpec
from musicvae_tpu_torch.data.synthetic import synth_corpus
from musicvae_tpu_torch.train.trainer import create_state
from torch_port_helpers import tiny_pair
from torch_port_helpers import one_torch_thread  # noqa: F401

DEADLINE = 60.0
GEN = GenSpec(num_bars=2, num_samples=2)


def _cfg(ema=0.9, **model_kw):
    _, tc = tiny_pair(use_pallas_conv1=True, **model_kw)
    return tc.replace(gen=GEN, train=dataclasses.replace(tc.train,
                                                         ema_decay=ema))


def _save(ck, cfg, step, seed):
    _, state = create_state(cfg, device="cpu", seed=seed)
    state.step.fill_(step)
    assert ckpt_io.save(ckpt_io.make_manager(ck), state, cfg, wait=True)


@pytest.fixture(scope="module")
def base_ckpt(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("socket_ckpt") / "ck")
    _save(ck, _cfg(), 1, seed=4)
    return ck


@pytest.fixture
def ck(base_ckpt, tmp_path):
    """A fresh copy of the step-1 checkpoint directory."""
    path = str(tmp_path / "ck")
    shutil.copytree(base_ckpt, path)
    return path


def _service(ck, use_ema=False):
    """A service over the newest step of ``ck``, reloading from it."""
    cfg, state = cli.restore_checkpoint(ck, "cpu",
                                        lambda c: c.replace(gen=GEN))
    service = cli.Service(cfg, state.ema_model if use_ema else state.model,
                          int(state.step))
    service.reload_once = cli._make_reload_once(ckpt_io.make_manager(ck),
                                                service, use_ema=use_ema)
    return service


@contextlib.contextmanager
def _server(service, max_requests, coalesce=1):
    """serve_socket on a free port in a thread, stopping itself after
    ``max_requests``; yields the port, then waits for it to return 0."""
    runner = (cli._CoalescedRunner(service, coalesce) if coalesce > 1
              else None)
    ready, result = threading.Event(), {}

    def on_listen(host, port):
        result["port"] = port
        ready.set()

    t = threading.Thread(target=lambda: result.update(rc=cli.serve_socket(
        service, "127.0.0.1", 0, max_requests, runner, "test",
        on_listen=on_listen)), daemon=True)
    t.start()
    assert ready.wait(DEADLINE), "the server did not start"
    yield result["port"]
    t.join(DEADLINE)
    assert not t.is_alive(), "the server did not stop"
    assert result["rc"] == 0


def _client(port):
    return ServeClient(port=port, timeout=DEADLINE)


def _serial(service, seed, seed_midi=None):
    """The MIDI the stdin path answers for a request."""
    req = {"seed": seed}
    if seed_midi is not None:
        req["seed_midi_b64"] = base64.b64encode(seed_midi).decode()
    return [base64.b64decode(m)
            for m in service.handle(json.dumps(req))["midi_b64"]]


@pytest.mark.parametrize("coalesce", [1, 2])
def test_two_concurrent_clients_get_their_own_responses(ck, coalesce):
    """Two clients, three requests each (one seeded), at once: each gets
    its own answers, in its order, equal to the stdin path's; under
    ``--coalesce 2`` the dispatcher batches across the clients."""
    service = _service(ck)
    midi = synth_corpus(1, 4, seed=2)[0][0]
    plans = {"a": [(1, None), (2, midi), (3, None)],
             "b": [(11, None), (12, None), (13, midi)]}
    got, errors = {}, []
    barrier = threading.Barrier(2, timeout=DEADLINE)

    def client(name, port):
        try:
            with _client(port) as c:
                barrier.wait()
                got[name] = [c.generate(seed=s, seed_midi=m)
                             for s, m in plans[name]]
        except Exception as e:          # reported by the main thread
            errors.append(e)

    with _server(service, max_requests=6, coalesce=coalesce) as port:
        threads = [threading.Thread(target=client, args=(n, port))
                   for n in plans]
        for t in threads:
            t.start()
        for t in threads:
            t.join(DEADLINE)
        assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for name, plan in plans.items():
        assert got[name] == [_serial(service, s, m) for s, m in plan], name
    assert service.served == 6 + 6 and service.errors == 0


def test_in_band_errors_keep_the_connection(ck):
    """Malformed requests are answered in-band under their id and count
    toward --max-requests; the connection and the service go on."""
    service = _service(ck)
    with _server(service, max_requests=5) as port, _client(port) as c:
        with pytest.raises(ServeError, match="unknown cmd 'nope'"):
            c.request({"cmd": "nope"})
        c._file.write("{not json\n")
        c._file.flush()
        assert "JSONDecodeError" in json.loads(c._file.readline())["error"]
        with pytest.raises(ServeError, match="SMFError"):
            c.generate(seed_midi=b"not midi")
        with pytest.raises(ServeError, match="outside the range"):
            c.generate(seed=2 ** 70)
        assert c.reload() is None           # nothing newer: not counted
        stats = c.stats()
        assert (stats["served"], stats["errors"], stats["step"]) == (0, 4, 1)
        assert len(c.generate(seed=3)) == 2
    assert (service.served, service.errors) == (1, 4)


def test_max_requests_stops_cleanly(ck):
    """After --max-requests generations the server returns 0 and its port
    is closed."""
    service = _service(ck)
    with _server(service, max_requests=2) as port:
        with _client(port) as c:
            assert len(c.generate(seed=1)) == 2
            assert len(c.generate(seed=2)) == 2
    with pytest.raises(OSError):
        ServeClient(port=port, timeout=5)
    assert service.served == 2


def test_push_and_poll_reload_move_step(ck):
    """Push: a newer step saved, then ``{"cmd": "reload"}`` swaps it in
    and ``stats`` shows it. Poll: with the watcher running, the next
    saved step arrives by itself. Each time the answers equal the stdin
    path's on the new weights."""
    service = _service(ck)
    cfg = _cfg()
    stop = threading.Event()
    with _server(service, max_requests=3, coalesce=2) as port, \
            _client(port) as c:
        before = c.generate(seed=5)
        assert c.stats()["step"] == 1
        _save(ck, cfg, 2, seed=20)
        ref2 = _service(ck)
        assert c.reload() == 2 and c.stats()["step"] == 2
        assert c.reload() is None
        after = c.generate(seed=5)
        assert after == _serial(ref2, 5) and after != before
        cli._start_reload_watcher(0.05, service.reload_once, stop)
        try:
            _save(ck, cfg, 3, seed=30)
            ref3 = _service(ck)
            for _ in range(int(DEADLINE / 0.05)):
                if c.stats()["step"] == 3:
                    break
                time.sleep(0.05)
            assert c.stats()["step"] == 3
            assert c.generate(seed=5) == _serial(ref3, 5)
        finally:
            stop.set()
    assert sorted(ckpt_io.make_manager(ck).all_steps()) == [1, 2, 3]


@pytest.mark.parametrize("case", ["ema", "structure"])
def test_reload_refusals(ck, case):
    """A newer step that the service cannot take is refused with the JAX
    package's message, in-band; the service keeps its step and weights,
    and the directory is left as it is (nothing quarantined)."""
    service = _service(ck, use_ema=True)
    before = _serial(_service(ck, use_ema=True), 7)
    if case == "ema":
        _save(ck, _cfg(ema=0.0), 2, seed=5)
        msg = ("step 2 carries no EMA weights but the service was started "
               "with --ema; retrain with --ema-decay or restart the "
               "service without --ema")
    else:
        _save(ck, _cfg(gru_hidden=48), 2, seed=5)
        msg = ("step 2 was trained with a different model structure than "
               "this service compiled for; restart the service on the new "
               "checkpoint")
    listing = sorted(os.listdir(ck))
    with _server(service, max_requests=2) as port, _client(port) as c:
        with pytest.raises(ServeError) as e:
            c.reload()
        assert str(e.value) == f"ValueError: {msg}"
        assert c.stats()["step"] == 1
        assert c.generate(seed=7) == before
    with pytest.raises(ValueError) as e:
        service.reload_once()
    assert str(e.value) == msg
    assert sorted(os.listdir(ck)) == listing


def test_sigterm_drains_and_exits_zero():
    """``serve --port`` as its own process (signal handlers live on the
    main thread): a SIGTERM after a served request stops the server,
    which reports the drain and exits 0."""
    import signal
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "musicvae_tpu_torch", "serve", "--device",
         "cpu", "--port", "0", "--bars", "1", "--samples", "1"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, stderr=subprocess.PIPE, text=True)
    lines, listening = [], threading.Event()

    def read():
        for line in proc.stderr:
            lines.append(line)
            if "listening on" in line:
                listening.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        assert listening.wait(DEADLINE), "".join(lines)
        port = int(next(ln for ln in lines if "listening on" in ln)
                   .rsplit(":", 1)[1])
        with _client(port) as c:
            assert len(c.generate(seed=1)) == 1
        proc.send_signal(signal.SIGTERM)
        proc.wait(DEADLINE)
        reader.join(DEADLINE)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(DEADLINE)
    err = "".join(lines)
    assert proc.returncode == 0, err
    assert "in-flight requests drained" in err
    assert "served 1 requests, 0 errors" in err
