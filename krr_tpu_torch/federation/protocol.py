"""The federation wire protocol: WAL frames over a byte stream.

A copy of `krr_tpu/federation/protocol.py` over the port's modules.

A shard↔aggregator connection is the durable store's on-disk framing
(`krr_tpu_torch.core.durastore.FRAME`) pointed at a socket instead of a file:

* the stream opens with an 8-byte magic (``KRRFED1\\n``, shard → aggregator);
* every message after it is one frame — ``[u32 LE payload_len]
  [u32 LE crc32(payload)][payload]`` — whose payload is a 1-byte message
  type followed by the body, so the CRC vouches for both;
* control messages (``HELLO`` / ``WELCOME`` / ``INVENTORY`` / ``ACK``)
  carry UTF-8 JSON bodies; ``DELTA`` bodies are the durastore record
  payload VERBATIM (`krr_tpu_torch.core.durastore.encode_ops` — the same bytes a
  WAL append would frame), with the shard's epoch and window metadata
  riding the record's own ``meta``.

Failure semantics mirror the WAL's torn-tail discipline: a connection that
dies mid-frame is a torn tail — the reader raises :class:`ProtocolError`
(or sees clean EOF at a frame boundary), the receiver discards the partial
message without applying anything (records decode FULLY before they
apply), and the sender re-sends everything past the receiver's acked epoch
on reconnect. A CRC mismatch (bit flip in flight) is the same verdict: the
connection drops, nothing half-applies, the re-send heals it. The
property-matrix tests in ``tests/test_federation.py`` drive
:func:`scan_messages` through the same cut/flip offsets the durastore's
torn-tail tests use.

Handshake (one round trip before any data):

* shard → ``HELLO {shard_id, generation, version, spec, clusters}`` —
  ``generation`` is a fresh id per shard-store lifetime (a restarted shard
  cannot re-send history its in-memory store no longer holds);
* aggregator → ``WELCOME {acked_epoch, generation, version}`` — the
  newest durably-acked epoch for this shard and the generation the
  aggregator knew it under (None for a first contact). A shard whose
  generation differs starts over: its first record carries
  ``extra["reset"] = true`` and the aggregator drops the shard's old rows
  before applying it (the full-backfill path).

Exactly-once: the aggregator accepts a ``DELTA`` only when its epoch is
exactly ``last_enqueued + 1`` (or any epoch on a reset record); an epoch at
or below the watermark is a duplicate from a re-send and is discarded
deterministically (counted, acked, never applied); a gap is a protocol
error that drops the connection so the shard re-sends from the ack.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Optional

from krr_tpu_torch.core.durastore import FRAME, frame_crc
from krr_tpu_torch.models.objects import K8sObjectData

#: Stream-opening magic (shard → aggregator, once per connection).
FED_MAGIC = b"KRRFED1\n"
#: Protocol version stamped into HELLO/WELCOME.
PROTOCOL_VERSION = 1

#: Message types — the first payload byte of every frame.
MSG_HELLO = b"H"
MSG_WELCOME = b"W"
MSG_INVENTORY = b"I"
MSG_DELTA = b"D"
MSG_ACK = b"A"
#: Epoch feed (aggregator → replica): one published epoch — rendered body,
#: pre-compressed variants, and the publish metadata a replica needs to
#: serve byte-identical responses/ETags. Subscribed via a HELLO carrying
#: ``role="replica"`` (a replica has no digest spec and sends no deltas).
MSG_EPOCH = b"E"

_KNOWN_TYPES = frozenset(
    (MSG_HELLO, MSG_WELCOME, MSG_INVENTORY, MSG_DELTA, MSG_ACK, MSG_EPOCH)
)

#: Hard per-message bound: a frame past it is a corrupt length field or a
#: hostile peer, not a fleet-scale delta (100k rows tick ≈ 5 MB).
MAX_MESSAGE_BYTES = 1 << 30

#: Bytes one frame adds around its body: the length/CRC header plus the
#: 1-byte message type (byte-accounting helpers subtract it so shard and
#: aggregator wire counters agree on BODY bytes).
FRAME_OVERHEAD = FRAME.size + 1


class ProtocolError(ValueError):
    """A framing violation: torn frame (connection died mid-message), CRC
    mismatch, unknown message type, oversized length, or an epoch the
    state machine cannot accept. The connection is unusable past it — the
    peer reconnects and the epoch handshake heals the stream."""


def encode_message(kind: bytes, body: bytes) -> bytes:
    """One framed message: ``FRAME(len, crc)`` over ``kind + body``."""
    payload = kind + body
    return FRAME.pack(len(payload), frame_crc(payload)) + payload


def encode_control(kind: bytes, **fields: Any) -> bytes:
    """A framed JSON control message (HELLO/WELCOME/ACK)."""
    return encode_message(kind, json.dumps(fields, sort_keys=True).encode("utf-8"))


def decode_control(body: bytes) -> dict:
    try:
        decoded = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise ProtocolError(f"undecodable control message: {e}") from e
    if not isinstance(decoded, dict):
        raise ProtocolError("control message is not a JSON object")
    return decoded


async def read_message(
    reader: asyncio.StreamReader, *, max_bytes: int = MAX_MESSAGE_BYTES
) -> "Optional[tuple[bytes, bytes]]":
    """Read one framed message: ``(type, body)``. Returns None on a CLEAN
    close (EOF exactly at a frame boundary — the peer finished); raises
    :class:`ProtocolError` on a torn frame (EOF mid-message — the partial
    message is discarded, nothing was applied), a CRC mismatch, an
    unknown type, or an oversized length."""
    try:
        header = await reader.readexactly(FRAME.size)
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None  # clean EOF at a frame boundary
        raise ProtocolError(
            f"connection closed mid-frame ({len(e.partial)} of {FRAME.size} "
            f"header bytes) — partial message discarded"
        ) from e
    length, crc = FRAME.unpack(header)
    if not 1 <= length <= max_bytes:
        raise ProtocolError(f"frame length {length} outside [1, {max_bytes}]")
    try:
        payload = await reader.readexactly(length)
    except asyncio.IncompleteReadError as e:
        raise ProtocolError(
            f"connection closed mid-frame ({len(e.partial)} of {length} "
            f"payload bytes) — partial message discarded"
        ) from e
    if frame_crc(payload) != crc:
        raise ProtocolError("frame CRC mismatch — corrupt message discarded")
    kind = payload[:1]
    if kind not in _KNOWN_TYPES:
        raise ProtocolError(f"unknown message type {kind!r}")
    return kind, payload[1:]


def scan_messages(blob: bytes) -> "tuple[list[tuple[bytes, bytes]], int]":
    """Parse framed messages out of a raw byte blob (no magic): the PURE
    twin of :func:`read_message`, for the torn-tail/bit-flip property
    matrix. Returns ``(messages, good_bytes)`` where ``good_bytes`` counts
    only whole, CRC-valid, known-type messages — everything past the first
    torn or corrupt frame is discarded, exactly like the WAL's recovery
    truncation."""
    messages: "list[tuple[bytes, bytes]]" = []
    good = 0
    pos = 0
    n = len(blob)
    while pos + FRAME.size <= n:
        length, crc = FRAME.unpack_from(blob, pos)
        if not 1 <= length <= MAX_MESSAGE_BYTES:
            break
        end = pos + FRAME.size + length
        if end > n:
            break
        payload = blob[pos + FRAME.size : end]
        if frame_crc(payload) != crc:
            break
        kind = payload[:1]
        if kind not in _KNOWN_TYPES:
            break
        messages.append((kind, payload[1:]))
        good = end
        pos = end
    return messages, good


# -------------------------------------------------------------- inventory
def encode_inventory(objects: "list[K8sObjectData]") -> bytes:
    """Serialize a shard's discovered fleet (the rendering metadata the
    aggregator needs beside the digest rows: allocations, pods, identity).
    Sent once per discovery refresh, not per tick — inventories change at
    discovery cadence while deltas flow at scan cadence."""
    return json.dumps(
        [obj.model_dump(mode="json") for obj in objects], sort_keys=True
    ).encode("utf-8")


def decode_inventory(body: bytes) -> "list[K8sObjectData]":
    try:
        items = json.loads(body.decode("utf-8"))
        return [K8sObjectData(**item) for item in items]
    except (UnicodeDecodeError, ValueError, TypeError) as e:
        raise ProtocolError(f"undecodable inventory: {e}") from e


# -------------------------------------------------------------- epoch feed
def encode_epoch_feed(
    *,
    epoch: int,
    changed_at: float,
    window_end: float,
    published_at: float,
    keys: "list[str]",
    body: bytes,
    variants: "Optional[dict[str, bytes]]" = None,
    extra: "Optional[dict]" = None,
) -> bytes:
    """Serialize one published epoch for the replica feed (MSG_EPOCH body):
    the rendered JSON body, any pre-compressed variants (the replica warms
    its response cache with them — same bytes the aggregator would serve),
    and the exact publish metadata (``epoch``/``changed_at`` drive the
    ETag, so replicas emit byte-identical validators). ``extra`` carries
    observability metadata (trace propagation context, freshness lineage)
    merged into the meta JSON — decoders pass unknown keys through, so old
    and new peers interoperate. Packed with ``np.savez`` like a delta
    record so the payload byte-arrays ride uncopied."""
    import io

    import numpy as np

    fields = {
        "epoch": int(epoch),
        "changed_at": float(changed_at),
        "window_end": float(window_end),
        "published_at": float(published_at),
        "keys": list(keys),
        "variants": sorted(variants) if variants else [],
    }
    if extra:
        fields.update({k: v for k, v in extra.items() if k not in fields})
    meta = json.dumps(fields, sort_keys=True).encode("utf-8")
    arrays = {
        "meta": np.frombuffer(meta, dtype=np.uint8),
        "body": np.frombuffer(body, dtype=np.uint8),
    }
    for encoding, blob in (variants or {}).items():
        arrays[f"v_{encoding}"] = np.frombuffer(blob, dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def decode_epoch_feed(payload: bytes) -> "tuple[dict, bytes, dict[str, bytes]]":
    """Inverse of :func:`encode_epoch_feed` → ``(meta, body, variants)``."""
    import io

    import numpy as np

    try:
        with np.load(io.BytesIO(payload)) as bundle:
            meta = json.loads(bundle["meta"].tobytes().decode("utf-8"))
            body = bundle["body"].tobytes()
            variants = {
                str(encoding): bundle[f"v_{encoding}"].tobytes()
                for encoding in meta.get("variants", [])
            }
    except (KeyError, ValueError, OSError, UnicodeDecodeError) as e:
        raise ProtocolError(f"undecodable epoch feed: {e}") from e
    if not isinstance(meta, dict):
        raise ProtocolError("epoch feed meta is not a JSON object")
    return meta, body, variants
