"""Multi-cluster federation: scatter-gather scanning over the delta-WAL wire.

A copy of `krr_tpu/federation/__init__.py` over the port's modules.

The last structural ceiling between this reproduction and the ROADMAP's
"millions of containers" target was that ONE event loop owned every
cluster's discover + fetch + fold. This package removes it by promoting the
durable store's WAL record (`krr_tpu_torch.core.durastore`) from a disk format to
a network protocol:

* scanner **shards** (`krr_tpu_torch.federation.shard`, one per cluster or
  namespace partition, launched via ``krr-tpu shard`` or in-process) each
  run the existing discover→fetch→fold pipeline locally and stream their
  tick's captured delta ops — the same CRC-framed, epoch-stamped,
  bit-exact-replayable records the WAL appends — to
* a central **aggregator** (`krr_tpu_torch.federation.aggregator`) embedded in
  ``krr-tpu serve``, which replays them into the fleet
  :class:`~krr_tpu_torch.core.streaming.DigestStore` exactly as WAL recovery
  does and publishes the merged view through the unchanged read path
  (/recommendations, history, hysteresis, timeline).

Exactly-once delivery falls out of the epoch machinery (per-shard epoch
watermarks: a reconnecting shard re-sends from the aggregator's acked
epoch, duplicates are discarded deterministically); per-shard failure
domains fall out of the quarantine pattern (a dead shard's last-good rows
keep serving with ``stale_since`` marks while healthy shards publish).
The wire format itself lives in `krr_tpu_torch.federation.protocol`.
"""

from krr_tpu_torch.federation.aggregator import Aggregator
from krr_tpu_torch.federation.protocol import (
    FED_MAGIC,
    PROTOCOL_VERSION,
    ProtocolError,
    encode_message,
    read_message,
    scan_messages,
)
from krr_tpu_torch.federation.shard import FederatedShard, run_shard

__all__ = [
    "Aggregator",
    "FED_MAGIC",
    "FederatedShard",
    "PROTOCOL_VERSION",
    "ProtocolError",
    "encode_message",
    "read_message",
    "run_shard",
    "scan_messages",
]
