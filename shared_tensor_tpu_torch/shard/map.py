"""ShardMap: the cluster's word-space partition and owner directory.

The counterpart of ``shared_tensor_tpu/shard/map.py`` (standard library
only; the port keeps its own copy). The table's flat word space ([0,
total//32): 32-element packed words, the RANGE/RDATA unit) is split into
``n_shards`` contiguous ranges at master creation; the split never
changes for the cluster's lifetime.
What DOES change is ownership: shard k's owner entry is
``(epoch, owner_id, host, port)``, minted by the master at claim-grant
time (epoch 1) and re-minted at every handoff/takeover (epoch+1). Nodes
merge entries per shard by epoch — the highest epoch wins — so the map
converges through any flood ordering, and "exactly one owner per shard"
is a property of the mint discipline (only the master grants, only the
current owner hands off) rather than of delivery order.

The map document rides wire.SHARD control messages ({"t": "map"} /
{"t": "grant"}), bounded by DIGEST_MAX_BYTES; ``shard_of_word`` is the
routing primitive the FWD plane keys on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class OwnerEntry:
    epoch: int = 0  # 0 = unowned
    owner: int = 0  # owner's node obs id (informational; identity is epoch)
    host: str = ""
    port: int = 0

    def as_doc(self) -> list:
        return [self.epoch, self.owner, self.host, self.port]

    @staticmethod
    def from_doc(doc) -> "OwnerEntry":
        e, o, h, p = doc
        return OwnerEntry(int(e), int(o), str(h), int(p))


class ShardMap:
    """Partition + owner directory for one sharded cluster."""

    def __init__(self, total_words: int, n_shards: int):
        if n_shards <= 0:
            raise ValueError(f"n_shards must be positive, got {n_shards}")
        if total_words < n_shards:
            raise ValueError(
                f"{total_words} words cannot split into {n_shards} shards"
            )
        self.total_words = int(total_words)
        self.n_shards = int(n_shards)
        # contiguous equal-ish split: the first (total % n) shards get one
        # extra word — deterministic from (total_words, n_shards) alone,
        # so every node derives identical ranges without negotiation
        base, extra = divmod(self.total_words, self.n_shards)
        self.ranges: list[tuple[int, int]] = []
        lo = 0
        for k in range(self.n_shards):
            cnt = base + (1 if k < extra else 0)
            self.ranges.append((lo, cnt))
            lo += cnt
        self.owners: list[OwnerEntry] = [
            OwnerEntry() for _ in range(self.n_shards)
        ]

    # -- geometry ------------------------------------------------------------

    def shard_of_word(self, word: int) -> int:
        if not 0 <= word < self.total_words:
            raise ValueError(
                f"word {word} outside [0, {self.total_words})"
            )
        base, extra = divmod(self.total_words, self.n_shards)
        # first `extra` shards are (base+1) words wide
        wide = extra * (base + 1)
        if word < wide:
            return word // (base + 1)
        return extra + (word - wide) // base if base else self.n_shards - 1

    def word_range(self, shard: int) -> tuple[int, int]:
        """(word_lo, word_cnt) of a shard."""
        return self.ranges[shard]

    def element_range(self, shard: int) -> tuple[int, int]:
        """[elo, ehi) element bounds of a shard (words * 32)."""
        lo, cnt = self.ranges[shard]
        return lo * 32, (lo + cnt) * 32

    # -- ownership -----------------------------------------------------------

    def merge_entry(self, shard: int, entry: OwnerEntry) -> bool:
        """Adopt ``entry`` iff its epoch is newer. Returns True on change."""
        if not 0 <= shard < self.n_shards:
            return False
        if entry.epoch > self.owners[shard].epoch:
            self.owners[shard] = entry
            return True
        return False

    def owner_of_shard(self, shard: int) -> Optional[OwnerEntry]:
        e = self.owners[shard]
        return e if e.epoch > 0 else None

    def owned_shards(self, owner_id: int) -> list[int]:
        return [
            k
            for k, e in enumerate(self.owners)
            if e.epoch > 0 and e.owner == owner_id
        ]

    def fully_owned(self) -> bool:
        return all(e.epoch > 0 for e in self.owners)

    def validate(self) -> list[str]:
        """Structural invariants ([] = clean): ranges form a contiguous
        exact cover of the word space, and no two shards share a live
        owner ENTRY epoch... ownership uniqueness per shard is structural
        (one entry per shard); what can go wrong is the cover."""
        bad = []
        lo = 0
        for k, (wlo, wcnt) in enumerate(self.ranges):
            if wlo != lo or wcnt <= 0:
                bad.append(
                    f"shard {k}: range [{wlo}, {wlo + wcnt}) breaks the "
                    f"contiguous cover at {lo}"
                )
            lo = wlo + wcnt
        if lo != self.total_words:
            bad.append(
                f"ranges cover [0, {lo}), table has {self.total_words} words"
            )
        return bad

    # -- wire ----------------------------------------------------------------

    def as_doc(self) -> dict:
        return {
            "words": self.total_words,
            "n": self.n_shards,
            "owners": [e.as_doc() for e in self.owners],
        }

    @staticmethod
    def from_doc(doc: dict) -> "ShardMap":
        m = ShardMap(int(doc["words"]), int(doc["n"]))
        for k, od in enumerate(doc.get("owners", [])):
            if k < m.n_shards:
                m.owners[k] = OwnerEntry.from_doc(od)
        return m

    def merge_doc(self, doc: dict) -> bool:
        """Merge a peer's map document entry-by-epoch. Returns True if
        anything changed. Geometry mismatches raise — two maps with
        different splits mean the cluster was misconfigured, which must
        be loud (a silently half-merged map would route FWDs into the
        wrong shard forever)."""
        if int(doc["words"]) != self.total_words or int(doc["n"]) != self.n_shards:
            raise ValueError(
                f"shard-map geometry mismatch: theirs "
                f"({doc.get('words')}w/{doc.get('n')}s) vs ours "
                f"({self.total_words}w/{self.n_shards}s)"
            )
        changed = False
        for k, od in enumerate(doc.get("owners", [])):
            if k < self.n_shards:
                changed |= self.merge_entry(k, OwnerEntry.from_doc(od))
        return changed

    def __repr__(self) -> str:  # pragma: no cover
        own = {
            k: f"e{e.epoch}@{e.host}:{e.port}"
            for k, e in enumerate(self.owners)
            if e.epoch > 0
        }
        return (
            f"ShardMap(words={self.total_words}, n={self.n_shards}, "
            f"owners={own})"
        )
