"""The reference-named shim and the protocol's version and capability bits.

The counterpart of ``shared_tensor_tpu/compat.py``. The reference's public
API is three Lua calls (``example.lua``)::

    a = sharedtensor.createOrFetch(host, port, tensor)
    a:copyToTensor(t)
    a:addFromTensor(t)

:func:`createOrFetch` returns an object with those names over the port's
peer (``comm/peer.py``); tensors are torch tensors (or numpy arrays) or
trees of them. ``copyToTensor`` returns a snapshot, torch tensors on the
peer's device, where the reference fills the caller's tensor.

Beside it live the versioning of the native DATA/BURST framing and the
handshake's capability flags, which ``comm/peer.py`` and ``serve/`` take
from here:

- ``WIRE_VERSION_V1`` is the framing without a trace; ``V2`` appends the
  13-byte trace (origin, origin ns, hops). Decoders take both (and the
  engine's aligned v3); what a peer emits is :func:`wire_protocol_version`.
- ``SYNC_FLAG_READ_ONLY`` / ``SYNC_FLAG_RANGE``: a read-only subscriber,
  with a word range to follow.
- ``SYNC_FLAG_SIGN2``: the peer decodes sign2 (2-bit) frames; native
  engines only. The parent's side rides WELCOME's flags byte.
- ``SYNC_FLAG_SHM``: the same-host shared-memory lane (a host id in the
  SYNC tail, a segment offer in WELCOME's); it also marks a peer that
  decodes the aligned v3 framing.
- ``SYNC_FLAG_SHARD``: the cluster-sharded tensor (a shard-index claim in
  the SYNC tail; a sharded parent's WELCOME carries the flag back). A
  classic parent ignores the claim and attaches a plain writer child, and
  the joiner falls back to the full-replica protocol (``shard/``).

The bits and versions are ``comm.wire``'s, re-exported here.
"""

from __future__ import annotations

import os
from typing import Any

from .comm.wire import (  # noqa: F401 (re-exported: serve/ and comm/peer.py read them here)
    SYNC_FLAG_RANGE,
    SYNC_FLAG_READ_ONLY,
    SYNC_FLAG_SHARD,
    SYNC_FLAG_SHM,
    SYNC_FLAG_SIGN2,
    WIRE_VERSION_V1,
    WIRE_VERSION_V2,
)
from .config import Config

WIRE_VERSION = WIRE_VERSION_V2  # what a peer emits by default


def sign2_mode(config: Config | None = None) -> int:
    """The engine's precision mode: 0 fixed 1-bit (``ST_SIGN2=0`` or
    ``CodecConfig.adaptive_precision`` off), 1 telemetry-adaptive (the
    default), 2 sign2 pinned on every capable link (``ST_SIGN2=2``). The
    caller checks that the peer runs the engine."""
    env = os.environ.get("ST_SIGN2", "1")
    if env == "0":
        return 0
    if config is not None and not config.codec.adaptive_precision:
        return 0
    return 2 if env == "2" else 1


def wire_protocol_version(config: Config | None = None) -> int:
    """The DATA/BURST framing this peer emits: v2 unless ``ST_WIRE_TRACE=0``
    or ``ObsConfig.trace_wire=False`` pins v1 (for trees of peers whose
    decoders reject the trace). The reference wire format ignores this."""
    if os.environ.get("ST_WIRE_TRACE", "1") == "0":
        return WIRE_VERSION_V1
    if config is not None and not config.obs.trace_wire:
        return WIRE_VERSION_V1
    return WIRE_VERSION_V2


class _CompatHandle:
    """The reference's userdata object: three methods and close."""

    def __init__(self, peer):
        self._peer = peer

    @property
    def peer(self):
        """The peer underneath (``comm.peer.SharedTensorPeer``)."""
        return self._peer

    def copyToTensor(self) -> Any:  # noqa: N802 (the reference's name)
        """A snapshot of the replica: torch tensors on the peer's device."""
        return self._peer.read()

    def addFromTensor(self, delta: Any) -> None:  # noqa: N802
        """Merge an additive update, streamed to every peer asynchronously."""
        self._peer.add(delta)

    def close(self) -> None:
        """Leave the tree; the other peers re-graft and carry on."""
        self._peer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def createOrFetch(  # noqa: N802 (the reference's name)
    host: str, port: int, tensor: Any, config: Config | None = None, device=None, host_tier: bool = False,
) -> _CompatHandle:
    """Create the shared tensor at host:port (the master, seeded from
    ``tensor``) or join the tree there, and block until ready.
    ``device=None`` is the GPU and raises without one; ``host_tier=True``
    runs on the CPU (the native engine unless the config says otherwise).
    With ``TransportConfig(wire_compat=True)`` the peer speaks the
    reference's wire format and joins trees of reference peers."""
    from .comm.peer import create_or_fetch

    return _CompatHandle(create_or_fetch(host, port, tensor, config, device=device, host_tier=host_tier))
