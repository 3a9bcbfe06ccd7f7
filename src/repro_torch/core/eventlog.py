"""Append-only event log for the durable control plane (DESIGN.md §15;
a copy of ``repro.core.eventlog``, which is stdlib only).

Every state transition of the long-running scheduler — submit, admit,
dispatch, preempt, repack, slice-alloc, complete, fault — becomes one
replayable JSONL record. The log is the source of truth: a restarted
control plane (core/controlplane.py) rebuilds the queue, fair-share
accounting, admission measurements and gang state by deterministically
re-executing the logged commands and verifying the regenerated event
stream byte-matches the logged prefix.

Guarantees:

  * durability — one fsync'd line per record; a crash can lose at most
    the record being written, never tear an earlier one (a torn final
    line is detected and dropped on replay);
  * total order — records carry monotonic sequence numbers starting at
    1 with no gaps; replay validates the chain;
  * epoch fencing — every writer claims the next epoch before
    appending by atomically creating a per-epoch marker file
    (``EPOCH-<n>``, O_CREAT|O_EXCL — concurrent claimants serialize,
    the loser re-bids a higher epoch); a takeover bumps it, and a
    zombie writer holding a stale epoch gets FencedError instead of a
    fork in the history. Within one directory the record stream is
    linearizable: seq strictly increasing, epochs non-decreasing;
  * compaction — a snapshot file (``snapshot-<seq>.json``) plus the
    records after it are equivalent to replay-from-the-beginning;
    ``compact()`` deletes segments wholly covered by the snapshot.

No clocks anywhere: records are ordered by sequence number, not wall
time, so replay equality is exact (registered in
analysis/config.DECISION_MODULES — the DET lint family enforces this).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, List, Optional, Tuple


class FencedError(RuntimeError):
    """Append rejected: another writer claimed a newer epoch (this
    writer is a zombie; it must stop, not retry)."""


class CorruptLogError(RuntimeError):
    """The record chain is broken somewhere other than a torn tail."""


class ReplayDivergence(RuntimeError):
    """Recovery re-execution produced an event that does not byte-match
    the logged record at the same position — the scheduler is not the
    deterministic function of the log it must be."""


def canonical(payload) -> str:
    """Canonical JSON: sorted keys, no whitespace. Tuples serialize as
    lists and floats as exact ``repr`` round-trips, so the canonical
    form of a freshly generated detail dict equals the canonical form
    of the same detail parsed back from the log — record equality is
    string equality."""
    return json.dumps(payload, sort_keys=True, separators=(",", ":"))


@dataclasses.dataclass(frozen=True)
class EventRecord:
    seq: int                            # 1-based, contiguous
    epoch: int                          # writer incarnation (fencing)
    kind: str
    payload: dict

    def line(self) -> str:
        return canonical({"seq": self.seq, "epoch": self.epoch,
                          "kind": self.kind, "payload": self.payload})


EPOCH_FILE = "EPOCH"
_SEG_PREFIX = "segment-"
_SNAP_PREFIX = "snapshot-"


class EventLog:
    """One log directory of fsync'd JSONL segments.

    Lifecycle: construct, ``claim()`` an epoch (mandatory before any
    append — this is the fencing handshake), then ``append()``.
    ``replay()`` and ``latest_snapshot()`` work without a claim, so
    read-only tooling never bumps the epoch."""

    def __init__(self, log_dir: str, fsync: bool = True):
        self.log_dir = log_dir
        self.fsync = fsync
        self.epoch: Optional[int] = None        # set by claim()
        self._next_seq: Optional[int] = None
        self._fh = None
        self._active: Optional[str] = None      # segment being appended
        self.recovered: List[EventRecord] = []  # claim()'s replay
        os.makedirs(log_dir, exist_ok=True)

    # ------------------------------------------------------------ fencing
    def stored_epoch(self) -> int:
        """Highest epoch any claimant has won: the max over the atomic
        per-epoch marker files and the human-readable ``EPOCH`` mirror
        (which may lag one beat behind the newest marker)."""
        best = 0
        path = os.path.join(self.log_dir, EPOCH_FILE)
        if os.path.exists(path):
            with open(path) as f:
                try:
                    best = int(f.read().strip() or 0)
                except ValueError:
                    best = 0    # garbled mirror: markers are the truth
        prefix = EPOCH_FILE + "-"
        for name in os.listdir(self.log_dir):
            if name.startswith(prefix):
                try:
                    best = max(best, int(name[len(prefix):]))
                except ValueError:
                    pass
        return best

    def claim(self) -> int:
        """Become the writer: atomically win the next epoch, repair any
        torn tail, and open a fresh segment. Any writer holding an
        older epoch is fenced from this moment — its next append
        raises.

        The epoch is won by creating the ``EPOCH-<n>`` marker with
        O_CREAT|O_EXCL: only one claimant can create a given marker, so
        two processes claiming concurrently serialize — the loser
        re-reads and bids on a higher epoch instead of sharing one.
        The records replayed while sizing ``_next_seq`` are retained in
        ``self.recovered`` so recovery need not parse the log twice."""
        while True:
            epoch = self.stored_epoch() + 1
            marker = os.path.join(self.log_dir,
                                  f"{EPOCH_FILE}-{epoch:06d}")
            try:
                fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                continue        # lost the race for this epoch; bid higher
            try:
                os.write(fd, f"{epoch}\n".encode())
                if self.fsync:
                    os.fsync(fd)
            finally:
                os.close(fd)
            break
        # human-readable mirror (atomic rename; tmp name is unique per
        # won epoch so concurrent claimants never share one).
        # stored_epoch() takes the max over markers and mirror, so a
        # slow mirror write can never un-fence a newer claimant.
        # Markers are NEVER deleted — one tiny file per restart —
        # because removing marker N would let a straggler holding a
        # stale stored_epoch() read re-win epoch N with O_EXCL
        path = os.path.join(self.log_dir, EPOCH_FILE)
        tmp = f"{path}.tmp-{epoch:06d}"
        with open(tmp, "w") as f:
            f.write(f"{epoch}\n")
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
        self.epoch = epoch
        self._repair_torn_tail()
        self.recovered = self.replay()
        snap = self.latest_snapshot()
        upto = snap[0] if snap is not None else 0
        last = self.recovered[-1].seq if self.recovered else 0
        # the snapshot floors the counter: after snapshot()+compact()
        # every segment may be empty, and restarting seq at 1 would
        # make new records invisible to replay-after-snapshot
        self._next_seq = max(last, upto) + 1
        self._open_segment()
        return epoch

    def _repair_torn_tail(self):
        """Physically truncate a torn final line (crash mid-append) so
        the tear cannot be buried behind the fresh segment this claim
        is about to open — replay() only forgives a torn line at the
        very end of the stream. Truncation is one syscall on the tail
        bytes; a crash here just leaves the tear for the next claim."""
        for name in reversed(self._segments()):
            path = os.path.join(self.log_dir, name)
            with open(path, "rb") as f:
                data = f.read()
            if not data.strip():
                continue            # empty segment from a dead claimant
            body = data.rstrip(b"\n")
            nl = body.rfind(b"\n")
            last = body[nl + 1:]
            try:
                row = json.loads(last.decode())
                EventRecord(seq=row["seq"], epoch=row["epoch"],
                            kind=row["kind"], payload=row["payload"])
            except (ValueError, KeyError, UnicodeDecodeError):
                os.truncate(path, nl + 1 if nl >= 0 else 0)
                if self.fsync:
                    fd = os.open(path, os.O_RDWR)
                    try:
                        os.fsync(fd)
                    finally:
                        os.close(fd)
            return      # only the last non-empty segment can be torn

    def _open_segment(self):
        name = f"{_SEG_PREFIX}{self._next_seq:010d}-e{self.epoch:06d}.jsonl"
        self._active = name
        self._fh = open(os.path.join(self.log_dir, name), "a")

    def roll(self):
        """Close the active segment and append to a fresh one starting
        at the next seq. Called after a snapshot so ``compact()`` can
        delete every covered segment without ever touching the file the
        writer holds open."""
        if self._fh is None:
            return
        self._fh.close()
        self._open_segment()

    def _check_fence(self):
        if self.epoch is None:
            raise RuntimeError("EventLog.append before claim()")
        if self.stored_epoch() != self.epoch:
            raise FencedError(
                f"epoch {self.epoch} fenced by epoch "
                f"{self.stored_epoch()}: this writer is a zombie")

    # ------------------------------------------------------------- append
    @property
    def last_seq(self) -> int:
        """Sequence number of the most recent durable record (0 = none).
        Only meaningful on a claimed (writing) log."""
        if self._next_seq is None:
            raise RuntimeError("last_seq before claim()")
        return self._next_seq - 1

    def append(self, kind: str, payload: dict) -> EventRecord:
        """Durably append one record. The fence is checked BEFORE the
        write, so a zombie's rejected append leaves no trace."""
        self._check_fence()
        rec = EventRecord(seq=self._next_seq, epoch=self.epoch,
                          kind=kind, payload=payload)
        self._fh.write(rec.line() + "\n")
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        self._next_seq += 1
        return rec

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # ------------------------------------------------------------- replay
    def _segments(self) -> List[str]:
        return sorted(f for f in os.listdir(self.log_dir)
                      if f.startswith(_SEG_PREFIX))

    def replay(self, after_seq: int = 0) -> List[EventRecord]:
        """All durable records with ``seq > after_seq``, validating the
        chain: contiguous seq, non-decreasing epochs. A torn final line
        (crash mid-write of the very last record — possibly followed
        only by empty segments a dead claimant left behind) is dropped;
        any other damage raises CorruptLogError. Writers additionally
        truncate the tear during claim() so it can never end up buried
        behind live records."""
        records: List[EventRecord] = []
        segs: List[Tuple[str, List[str]]] = []
        for name in self._segments():
            with open(os.path.join(self.log_dir, name)) as f:
                segs.append((name, f.read().splitlines()))
        last_pos = None     # (seg idx, line idx) of the stream's tail
        for si, (_, lines) in enumerate(segs):
            for li, line in enumerate(lines):
                if line.strip():
                    last_pos = (si, li)
        for si, (name, lines) in enumerate(segs):
            for li, line in enumerate(lines):
                if not line.strip():
                    continue
                try:
                    row = json.loads(line)
                    rec = EventRecord(seq=row["seq"], epoch=row["epoch"],
                                      kind=row["kind"],
                                      payload=row["payload"])
                except (ValueError, KeyError) as e:
                    if (si, li) == last_pos:
                        break           # torn tail: crash mid-append
                    raise CorruptLogError(
                        f"{name}:{li + 1}: unparseable record") from e
                if records:
                    prev = records[-1]
                    if rec.seq != prev.seq + 1:
                        raise CorruptLogError(
                            f"{name}:{li + 1}: seq {rec.seq} after "
                            f"{prev.seq} (gap or fork)")
                    if rec.epoch < prev.epoch:
                        raise CorruptLogError(
                            f"{name}:{li + 1}: epoch went backwards "
                            f"({prev.epoch} -> {rec.epoch})")
                records.append(rec)
        return [r for r in records if r.seq > after_seq]

    # ---------------------------------------------------------- snapshots
    def write_snapshot(self, state: dict, upto: int) -> str:
        """Persist ``state`` as the recovered-state equivalent of records
        1..upto (atomic rename). Recovery loads the newest snapshot and
        replays only the records after it."""
        name = f"{_SNAP_PREFIX}{upto:010d}.json"
        path = os.path.join(self.log_dir, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"upto": upto, "state": state}, f, sort_keys=True)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if self._fh is not None:
            self.roll()         # future appends land past the snapshot
        return path

    def latest_snapshot(self) -> Optional[Tuple[int, dict]]:
        """(upto_seq, state) of the newest snapshot, or None."""
        snaps = sorted(f for f in os.listdir(self.log_dir)
                       if f.startswith(_SNAP_PREFIX)
                       and not f.endswith(".tmp"))
        if not snaps:
            return None
        with open(os.path.join(self.log_dir, snaps[-1])) as f:
            row = json.load(f)
        return int(row["upto"]), row["state"]

    def compact(self) -> List[str]:
        """Delete segments wholly covered by the newest snapshot (every
        record's seq <= snapshot upto). Partially covered segments stay;
        replay(after_seq=upto) skips their prefix. Returns the deleted
        file names."""
        snap = self.latest_snapshot()
        if snap is None:
            return []
        upto, _ = snap
        removed = []
        for name in self._segments():
            if name == self._active:
                continue        # never unlink the open segment
            path = os.path.join(self.log_dir, name)
            with open(path) as f:
                lines = [ln for ln in f.read().splitlines() if ln.strip()]
            if not lines:
                continue
            try:
                last_seq = json.loads(lines[-1])["seq"]
            except (ValueError, KeyError):
                continue                # torn tail lives in the live segment
            if last_seq <= upto:
                os.remove(path)
                removed.append(name)
        return removed


# ---------------------------------------------------------------------------
# shared decision-record schema (live scheduler + simulator)
# ---------------------------------------------------------------------------

#: Normalized job-level decision rows both the live scheduler's event
#: stream and the simulator's recorder reduce to — same kinds, same
#: field names, so a live log and a sim log of one workload diff
#: field-by-field (DESIGN.md §15).
DECISION_SCHEMA: Dict[str, Tuple[str, ...]] = {
    "submit": ("job", "user", "nodes"),
    "reject": ("job", "user", "reason"),
    "dispatch_gang": ("job", "user", "width"),
    "lane_backfill": ("job", "user", "lanes"),
    "spatial_dispatch": ("job", "user", "lanes"),
    "preempt": ("job", "user"),
    "complete": ("job", "user"),
}


def normalize_live(kind: str, detail: dict) -> Optional[dict]:
    """Map one live-scheduler event onto the shared decision schema
    (None = not a job-level decision: per-task dispatch/done, replans,
    releases and telemetry stay in the raw log only)."""
    if kind == "submit":
        return {"kind": kind, "job": detail["job"], "user": detail["user"],
                "nodes": detail["nodes"]}
    if kind == "reject":
        return {"kind": kind, "job": detail["job"], "user": detail["user"],
                "reason": detail["reason"]}
    if kind == "alloc" and "job" in detail:
        return {"kind": "dispatch_gang", "job": detail["job"],
                "user": detail["user"], "width": len(detail["nodes"])}
    if kind == "resume":
        return {"kind": "dispatch_gang", "job": detail["job"],
                "user": detail["user"], "width": detail["width"]}
    if kind == "lane_backfill":
        return {"kind": kind, "job": detail["job"], "user": detail["user"],
                "lanes": detail["lanes"]}
    if kind == "spatial_dispatch":
        return {"kind": kind, "job": detail["job"], "user": detail["user"],
                "lanes": detail["lanes"]}
    if kind == "preempt":
        return {"kind": kind, "job": detail["job"], "user": detail["user"]}
    if kind == "complete":
        return {"kind": kind, "job": detail["job"], "user": detail["user"]}
    return None


def decision_view(records: Iterable) -> List[dict]:
    """Normalized decision rows of an EventRecord sequence (or of
    (kind, detail) pairs), in log order."""
    rows = []
    for rec in records:
        if isinstance(rec, EventRecord):
            kind, detail = rec.kind, rec.payload
        else:
            kind, detail = rec
        row = normalize_live(kind, detail)
        if row is not None:
            rows.append(row)
    return rows


def diff_decision_logs(a: List[dict], b: List[dict]) -> List[str]:
    """Field-by-field diff of two normalized decision views — the
    live-vs-sim comparison tool. Rows are grouped per kind (the two
    engines interleave kinds differently: rounds vs virtual time);
    within a kind the sequences must match exactly."""
    out = []
    kinds = sorted({r["kind"] for r in a} | {r["kind"] for r in b})
    for kind in kinds:
        ra = [canonical(r) for r in a if r["kind"] == kind]
        rb = [canonical(r) for r in b if r["kind"] == kind]
        if ra != rb:
            only_a = [r for r in ra if r not in rb]
            only_b = [r for r in rb if r not in ra]
            out.append(f"{kind}: {len(ra)} vs {len(rb)} rows; "
                       f"only-left={only_a} only-right={only_b}")
    return out
