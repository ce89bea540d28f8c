"""Python client for the ``serve --port`` TCP protocol (stdlib only).

The port's copy of the JAX package's client.py: the two services speak the
same line-delimited JSON (see cli.py's module docstring for the
request/response schema). This client wraps one connection with typed
helpers and decodes responses to bytes, so downstream code never touches
base64 or sockets:

    from musicvae_tpu_torch.client import ServeClient
    with ServeClient(port=7700) as c:
        midis = c.generate(seed=7)               # [SMF bytes, ...]
        cont  = c.generate(seed_midi=open("seed.mid", "rb").read())
        print(c.stats()["step"])                 # live service counters

Errors the service reports in-band (out-of-range chord, bad seed MIDI,
device failures) raise ``ServeError`` with the service's message; the
connection stays usable afterwards — mirroring the service's own
contract that a bad request never kills anything.
"""

from __future__ import annotations

import base64
import json
import socket
from typing import Any, Dict, List, Optional


class ServeError(RuntimeError):
    """An in-band error response from the service (the request failed;
    the connection and the service are both still healthy)."""


class ServeClient:
    """One TCP connection to a ``serve --port`` service. Thread-safe for
    one request at a time per instance (the protocol is strictly
    request→response per connection); open one client per thread for
    concurrent load — the service multiplexes connections onto its one
    model (and batches them under ``--coalesce``)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 7700,
                 timeout: float = 600.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._file = self._sock.makefile("rw")
        self._next_id = 0

    def close(self) -> None:
        try:
            self._file.close()
        finally:
            self._sock.close()

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def request(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """Send one raw request dict, return the raw response dict (an
        ``id`` is added if missing). Raises ServeError on an in-band
        error response, ConnectionError if the service went away."""
        if "id" not in req:
            req = dict(req, id=self._next_id)
            self._next_id += 1
        self._file.write(json.dumps(req) + "\n")
        self._file.flush()
        line = self._file.readline()
        if not line:
            raise ConnectionError("service closed the connection")
        resp = json.loads(line)
        if "error" in resp:
            raise ServeError(resp["error"])
        return resp

    def generate(self, seed: Optional[int] = None,
                 chord: Optional[int] = None, key: Optional[int] = None,
                 seed_midi: Optional[bytes] = None) -> List[bytes]:
        """One generation request → list of SMF files (bytes), one per
        sample (the sample count/bars are fixed by the service's
        --samples/--bars). ``seed_midi``: raw SMF bytes whose last bar
        seeds the prev-bar conditioning."""
        req: Dict[str, Any] = {}
        if seed is not None:
            req["seed"] = int(seed)
        if chord is not None:
            req["chord"] = int(chord)
        if key is not None:
            req["key"] = int(key)
        if seed_midi is not None:
            req["seed_midi_b64"] = base64.b64encode(seed_midi).decode()
        resp = self.request(req)
        return [base64.b64decode(m) for m in resp["midi_b64"]]

    def stats(self) -> Dict[str, Any]:
        """Live service counters: served/errors/requests, checkpoint
        ``step`` (watch hot reloads land), config name, request shape,
        uptime."""
        return self.request({"cmd": "stats"})["stats"]

    def reload(self) -> Optional[int]:
        """Push-style checkpoint reload: ask the service to check its
        checkpoint directory NOW (e.g. right after a training save)
        instead of waiting out its --reload-every poll. Returns the new
        step, or None if the service was already current."""
        return self.request({"cmd": "reload"})["reloaded"]
