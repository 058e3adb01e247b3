"""Three-tier residency of staged tables: the device (hot) <-> host RAM
(warm) <-> disk (cold), driven by workload heat (port of
``pinot_tpu.engine.residency``).

  hot   the staged tensors in the executor's staging cache, registered
        with its ``StagingLedger``; queries launch against them.
  warm  the SAME packed layout copied to host numpy arrays (one
        device-to-host copy a tensor, into pinned memory on the card);
        promotion back is one host-to-device copy a tensor, no re-encode.
  cold  the warm snapshot spooled to disk as one ``.npz`` in the packed
        layout; the column and shape metadata stays in RAM, so promotion
        needs no segment access.

Heat is an exponentially decayed touch counter a table, weighted by its
reload cost (``tiercost.h2d_cost_ns``): the coldest table by frequency x
cost is demoted first.  The constants are the reference's, so the port
demotes in the reference's order.

Correctness invariants (the reference's):

- Demotion never frees a table a query is using: queries ``pin`` their
  staged table's token (a refcount) for their whole device section, and
  the victim choice skips pinned and excluded tokens.  A query already
  holding the tensors keeps them alive through Python references anyway.
- Promotion mints a NEW staging token (``restore_staged`` builds a new
  ``StagedTable``), so a coalesce or batch key of the demoted table can
  never match the promoted one.
- Tier moves are ledger-exact: demotion drops the ledger entry (an
  eviction), promotion re-measures and re-registers, and the warm and
  cold byte totals are measured off the numpy arrays.

One manager a ``QueryExecutor``, over that executor's staging cache,
ledger and transfer stats (the reference keeps one a process; every
server process has one executor).  Its caps are attributes, given by the
executor's constructor (``engine/config.py`` defaults; the server
starters read the reference's environment names):

  hbm_cap_bytes        hot byte cap; 0 = uncapped.
  host_cap_bytes       warm byte cap; 0 = warm snapshots never spill.
  stage_cache_entries  hot entry cap (default 32).
  spool_dir            the cold spool (None: a temp dir for the process).

Lock order: the executor's staging lock (``guard``) before the manager's
own lock; the ledger's lock is a leaf.

Left out: sharded placements (every staged table here is on one device,
so every entry is demotable; the reference's drop-only
``capEvictions`` stays at 0).
"""
from __future__ import annotations

import atexit
import itertools
import os
import queue
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pinot_tpu_torch.engine import config, tiercost
from pinot_tpu_torch.engine.device import _ROLE_ATTRS, StagedColumn, StagedTable
from pinot_tpu_torch.engine.plandigest import _raw_table


# ---------------------------------------------------------------------------
# Packed-layout snapshot and restore (the zero-re-encode contract)
# ---------------------------------------------------------------------------


def _to_host(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Device tensors -> host numpy arrays: on the card, one
    device-to-host copy each into pinned memory, then one synchronize; on
    the CPU the tensors' own memory."""
    if not tensors or tensors[0].device.type == "cpu":
        return [t.numpy() for t in tensors]
    hosts = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        hosts.append(h)
    torch.cuda.synchronize(tensors[0].device)
    return [h.numpy() for h in hosts]


def snapshot_staged(st: StagedTable) -> Tuple[Dict[str, Any], int]:
    """Snapshot a staged table's tensors to host numpy in the SAME packed
    layout.  Returns (snapshot, host bytes).  The snapshot holds
    everything ``restore_staged`` needs and no segment."""
    names, attrs, tensors = [], [], [st.num_docs_arr]
    for name, sc in st.columns.items():
        for attr, _role in _ROLE_ATTRS:
            t = getattr(sc, attr)
            if t is not None:
                names.append(name)
                attrs.append(attr)
                tensors.append(t)
    hosts = _to_host(tensors)
    nbytes = sum(int(h.nbytes) for h in hosts)
    columns: Dict[str, Dict[str, Any]] = {
        name: {
            "meta": {
                "stored_type": sc.stored_type,
                "single_value": sc.single_value,
                "card_pad": sc.card_pad,
                "mv_pad": sc.mv_pad,
                "cards": sc.cards,
                "bsi_width": sc.bsi_width,
                "bsiv_width": sc.bsiv_width,
                "bsiv_min": sc.bsiv_min,
            },
            "arrays": {},
        }
        for name, sc in st.columns.items()
    }
    for name, attr, host in zip(names, attrs, hosts[1:]):
        columns[name]["arrays"][attr] = host
    snap = {
        "segment_names": st.segment_names,
        "num_segments": st.num_segments,
        "n_pad": st.n_pad,
        "num_docs": st.num_docs,
        "num_docs_arr": hosts[0],
        "columns": columns,
        # host zone maps (engine/zonemap.py): derived data, kept so the
        # promoted table's first block decision is not a cold one
        "zones": st.zones,
    }
    return snap, nbytes


def _to_device(host: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(host)
    if device.type == "cpu":
        return t
    # a warm array lies in pinned memory: the copy is one asynchronous
    # DMA (a cold one, loaded into pageable memory, copies synchronously)
    return t.to(device, non_blocking=True)


def restore_staged(snap: Dict[str, Any], device: torch.device, precision: config.Precision) -> StagedTable:
    """Rebuild a hot staged table from a warm snapshot: one host-to-device
    copy a tensor, no re-encode.  Mints a NEW staging token (the dataclass
    default), so the promoted table never aliases a launch that was in
    flight against the demoted one."""
    st = StagedTable(
        segment_names=tuple(snap["segment_names"]),
        num_segments=int(snap["num_segments"]),
        n_pad=int(snap["n_pad"]),
        num_docs=tuple(snap["num_docs"]),
        num_docs_arr=_to_device(snap["num_docs_arr"], device),
        device=device,
        precision=precision,
        zones=dict(snap.get("zones") or {}),
    )
    for name, col in snap["columns"].items():
        meta = col["meta"]
        sc = StagedColumn(
            name=name,
            stored_type=meta["stored_type"],
            single_value=bool(meta["single_value"]),
            card_pad=int(meta["card_pad"]),
            cards=tuple(meta["cards"]),
            mv_pad=int(meta["mv_pad"]),
            bsi_width=int(meta["bsi_width"]),
            bsiv_width=int(meta["bsiv_width"]),
            bsiv_min=meta["bsiv_min"],
        )
        for attr, host in col["arrays"].items():
            setattr(sc, attr, _to_device(host, device))
        st.columns[name] = sc
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return st


# ---------------------------------------------------------------------------
# The residency manager
# ---------------------------------------------------------------------------


@dataclass
class _Entry:
    key: Tuple
    table: str
    segments: Tuple[str, ...]
    state: str  # "hot" | "warm" | "cold"
    nbytes: int
    heat: float = 1.0
    last_touch: float = field(default_factory=time.monotonic)
    staged: Any = None  # StagedTable while hot
    snap: Optional[Dict[str, Any]] = None  # packed snapshot while warm
    path: Optional[str] = None  # .npz spool file while cold
    meta: Optional[Dict[str, Any]] = None  # shape and column meta while cold


_COUNTER_NAMES = (
    "demotions",  # hot -> warm
    "promotions",  # warm / cold -> hot
    "coldDemotions",  # warm -> cold (disk spill)
    "coldLoads",  # cold -> warm (disk read, promotion or prefetch)
    "coldDrops",  # spool unwritable or unreadable: the entry dropped instead
    "pressureDemotions",  # demotions forced by an OOM heal, not a cap
    "capEvictions",  # non-demotable entries dropped at the cap (none here)
    "prefetches",  # background cold -> warm lifts ahead of dispatch
    "demotedBytes",
    "promotedBytes",
)


class ResidencyManager:
    """Tier state for one executor's staged tables (module docstring).
    ``cache`` is the executor's staging cache, ``guard`` the lock that
    serializes staging (re-entrant: ``get_staged`` calls ``enforce``
    under it)."""

    def __init__(
        self,
        cache: Dict[Tuple, StagedTable],
        ledger,
        transfers,
        guard,
        device: torch.device,
        precision: config.Precision,
        hbm_cap_bytes: int = config.HBM_CAP_BYTES,
        host_cap_bytes: int = config.HOST_CAP_BYTES,
        stage_cache_entries: int = config.STAGE_CACHE_ENTRIES,
        spool_dir: Optional[str] = None,
    ) -> None:
        self._cache = cache
        self.ledger = ledger
        self.transfers = transfers
        self._guard = guard
        self.device = device
        self.precision = precision
        self.hbm_cap_bytes = int(hbm_cap_bytes)
        self.host_cap_bytes = int(host_cap_bytes)
        self.stage_cache_entries = int(stage_cache_entries)
        self.spool_dir = spool_dir
        self._lock = threading.RLock()
        self._entries: Dict[Tuple, _Entry] = {}
        self._pins: Dict[int, int] = {}  # staging token -> refcount
        self._token_keys: Dict[int, Tuple] = {}  # hot token -> cache key
        self._dir: Optional[str] = None
        self._file_seq = itertools.count()
        self.counters: Dict[str, int] = {n: 0 for n in _COUNTER_NAMES}
        # the background promotion worker (cold -> warm ahead of dispatch):
        # started lazily, a daemon, best effort (the synchronous path stays
        # correct without it)
        self._prefetch_q: "queue.Queue[Tuple]" = queue.Queue()
        self._prefetch_thread: Optional[threading.Thread] = None

    # -- pins (queries in flight) -------------------------------------
    def pin(self, token: int) -> None:
        with self._lock:
            self._pins[token] = self._pins.get(token, 0) + 1

    def unpin(self, token: int) -> None:
        with self._lock:
            n = self._pins.get(token, 0) - 1
            if n > 0:
                self._pins[token] = n
            else:
                self._pins.pop(token, None)

    def pin_count(self, token: int) -> int:
        with self._lock:
            return self._pins.get(token, 0)

    # -- heat ------------------------------------------------------------
    def _decayed_heat(self, e: _Entry, now: float) -> float:
        hl = max(1e-3, tiercost.residency_halflife_s())
        return e.heat * (0.5 ** (max(0.0, now - e.last_touch) / hl))

    def _score(self, e: _Entry, now: float) -> float:
        """Victim order: decayed touch frequency x reload cost; the lowest
        score is the coldest, demoted first."""
        return self._decayed_heat(e, now) * tiercost.h2d_cost_ns(max(1, e.nbytes))

    def _touch_locked(self, e: _Entry, weight: float = 1.0) -> None:
        now = time.monotonic()
        e.heat = self._decayed_heat(e, now) + weight
        e.last_touch = now

    # -- registration (device.get_staged; the caller holds the guard) ---
    def restore(self, snap: Dict[str, Any]) -> StagedTable:
        return restore_staged(snap, self.device, self.precision)

    def register(self, key: Tuple, staged: StagedTable, table: str, promoted: bool) -> None:
        """A table just became device-resident (a fresh staging or a
        promotion): measure it into the ledger, note it hot, mark the
        upload, prefetch its table's other cold entries after a promotion,
        and demote past the caps (never this table)."""
        nbytes = self.ledger.update(staged, table)
        self.note_hot(key, staged, table, nbytes, promoted)
        # a staging IS one host-to-device burst of the measured bytes; a
        # promotion's copies are the same physical transfer
        self.transfers.record_h2d(nbytes)
        if promoted:
            self.prefetch_siblings(key, table)
        self.enforce(exclude_tokens=(staged.token,))

    def note_hot(self, key: Tuple, staged: StagedTable, table: str, nbytes: int, promoted: bool) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = _Entry(key=key, table=table, segments=tuple(staged.segment_names), state="hot",
                           nbytes=int(nbytes))
                self._entries[key] = e
            else:
                self._remove_payload_locked(e)
                e.state, e.nbytes = "hot", int(nbytes)
                self._touch_locked(e)
            e.staged = staged
            self._token_keys[staged.token] = key
            if promoted:
                self.counters["promotions"] += 1
                self.counters["promotedBytes"] += int(nbytes)

    def touch(self, key: Tuple) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                self._touch_locked(e)

    def remeasure(self, key: Tuple, staged: StagedTable, attached: int) -> None:
        """Planes attached to a hot table: re-measure it (only while it is
        still the cached one: a demoted table is counted out already)."""
        with self._guard:
            if self._cache.get(key) is staged:
                with self._lock:
                    e = self._entries.get(key)
                    table = e.table if e is not None else ""
                nbytes = self.ledger.update(staged, table)
                with self._lock:
                    if e is not None and e.state == "hot":
                        e.nbytes = int(nbytes)
        self.transfers.record_h2d(attached)

    def take_resident(self, key: Tuple) -> Optional[Dict[str, Any]]:
        """The warm or cold payload of ``key`` for promotion (the caller
        holds the guard), or None when it has no resident copy."""
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.state == "hot":
                return None
            if e.state == "warm":
                return e.snap
            return self._load_cold_locked(e)

    # -- dropping (segments replaced, committed or dropped; clears) -------
    def drop_key(self, key: Tuple) -> None:
        """Drop ``key`` from every tier: its hot table leaves the cache and
        the ledger, a warm or cold copy is freed (a re-loaded segment mints
        new staging tokens, so the key can never be asked for again)."""
        with self._guard:
            with self._lock:
                st = self._cache.pop(key, None)
                if st is not None:
                    self.ledger.drop(st)
                    self._token_keys.pop(st.token, None)
                e = self._entries.pop(key, None)
                if e is not None:
                    self._remove_payload_locked(e)

    def drop_where(self, stale: Callable[[Tuple], bool]) -> int:
        """Drop, from every tier, each key whose segment set ((name, crc,
        token) each) ``stale`` accepts.  Returns the keys dropped."""
        with self._guard:
            with self._lock:
                victims = {k for k in list(self._entries) + list(self._cache) if stale(k[0])}
                for k in victims:
                    self.drop_key(k)
        return len(victims)

    def drop_segment(self, segment_name: str) -> int:
        """Drop every entry (any tier) that holds the segment."""
        return self.drop_where(lambda idents: any(i[0] == segment_name for i in idents))

    # -- demotion ----------------------------------------------------------
    def enforce(self, exclude_tokens: Sequence[int] = ()) -> int:
        """Demote until the hot tier fits its caps (the byte cap and the
        entry cap).  Returns the device bytes freed.  Pinned and excluded
        tables are never victims: the cap bounds idle residency, not the
        set a query is using."""
        freed = 0
        exclude = set(exclude_tokens)
        while True:
            with self._guard:
                with self._lock:
                    hot = [e for e in self._entries.values() if e.state == "hot"]
                    hot_bytes = sum(e.nbytes for e in hot)
                    over = (self.hbm_cap_bytes > 0 and hot_bytes > self.hbm_cap_bytes) or (
                        self.stage_cache_entries > 0 and len(self._cache) > self.stage_cache_entries
                    )
                    if not over:
                        break
                    victim = self._pick_victim_locked(hot, exclude)
                    if victim is None:
                        break  # everything hot is pinned or excluded
                    freed += self._demote_locked(victim)
        self._enforce_warm_cap()
        return freed

    def demote_for_pressure(self, exclude_tokens: Sequence[int] = (), min_bytes: int = 1) -> int:
        """The OOM heal's hook: the card just refused an allocation, so
        demote the coldest unpinned tables whatever the caps say, until
        ``min_bytes`` are freed.  Returns the bytes freed (0: nothing was
        demotable, and the caller's retry will fail over to the host)."""
        freed = 0
        exclude = set(exclude_tokens)
        while freed < max(1, min_bytes):
            with self._guard:
                with self._lock:
                    hot = [e for e in self._entries.values() if e.state == "hot"]
                    victim = self._pick_victim_locked(hot, exclude)
                    if victim is None:
                        break
                    freed += self._demote_locked(victim)
                    self.counters["pressureDemotions"] += 1
        self._enforce_warm_cap()
        return freed

    def _pick_victim_locked(self, hot: List[_Entry], exclude: set) -> Optional[_Entry]:
        now = time.monotonic()
        best: Optional[_Entry] = None
        best_score = 0.0
        for e in hot:
            tok = e.staged.token if e.staged is not None else None
            if tok is None or tok in exclude or self._pins.get(tok, 0) > 0:
                continue
            score = self._score(e, now)
            if best is None or score < best_score:
                best, best_score = e, score
        return best

    def _demote_locked(self, e: _Entry) -> int:
        """hot -> warm.  The caller holds the guard and the lock."""
        staged = e.staged
        if self._cache.get(e.key) is staged:
            self._cache.pop(e.key, None)
        hot_bytes = int(e.nbytes)
        self.ledger.drop(staged)
        self._token_keys.pop(staged.token, None)
        e.staged = None
        snap, host_bytes = snapshot_staged(staged)
        self.transfers.record_d2h(host_bytes)
        e.snap, e.state, e.nbytes = snap, "warm", host_bytes
        self.counters["demotions"] += 1
        self.counters["demotedBytes"] += host_bytes
        return hot_bytes

    def _enforce_warm_cap(self) -> None:
        """Spill the coldest warm snapshots to disk while over the host
        cap.  An unwritable spool drops the entry instead (the segments
        still exist: a later query stages from them)."""
        cap = self.host_cap_bytes
        if cap <= 0:
            return
        with self._lock:
            while True:
                warm = [e for e in self._entries.values() if e.state == "warm"]
                if not warm or sum(e.nbytes for e in warm) <= cap:
                    return
                now = time.monotonic()
                self._spill_locked(min(warm, key=lambda e: self._score(e, now)))

    def _spool_dir(self) -> Optional[str]:
        if self._dir is None:
            try:
                if self.spool_dir:
                    os.makedirs(self.spool_dir, exist_ok=True)
                    self._dir = self.spool_dir
                else:
                    self._dir = tempfile.mkdtemp(prefix="pinot_tpu_torch_resid_")
                    atexit.register(shutil.rmtree, self._dir, ignore_errors=True)
            except OSError:
                self._dir = None
        return self._dir

    def _spill_locked(self, e: _Entry) -> None:
        """warm -> cold: the arrays to one .npz in the packed layout; the
        shape and column metadata stays in RAM."""
        snap = e.snap
        d = self._spool_dir()
        if snap is None or d is None:
            self._entries.pop(e.key, None)
            self.counters["coldDrops"] += 1
            return
        arrays: Dict[str, np.ndarray] = {"nd:num_docs_arr": snap["num_docs_arr"]}
        order = sorted(snap["columns"])
        meta = {
            "segment_names": snap["segment_names"],
            "num_segments": snap["num_segments"],
            "n_pad": snap["n_pad"],
            "num_docs": snap["num_docs"],
            "zones": snap.get("zones"),
            "column_order": order,
            "column_meta": {n: snap["columns"][n]["meta"] for n in order},
            "column_attrs": {n: sorted(snap["columns"][n]["arrays"]) for n in order},
        }
        for ci, name in enumerate(order):
            for attr, arr in snap["columns"][name]["arrays"].items():
                arrays[f"{ci}:{attr}"] = arr
        path = os.path.join(d, f"resid_{os.getpid()}_{next(self._file_seq)}.npz")
        try:
            with open(path, "wb") as f:
                np.savez(f, **arrays)
        except OSError:
            self._entries.pop(e.key, None)
            self.counters["coldDrops"] += 1
            return
        e.snap, e.state, e.path, e.meta = None, "cold", path, meta
        self.counters["coldDemotions"] += 1

    def _load_cold_locked(self, e: _Entry) -> Optional[Dict[str, Any]]:
        """cold -> warm (one sequential read, no re-encode).  A failed
        read drops the entry: the caller stages from the segments."""
        meta, path = e.meta, e.path
        if meta is None or path is None:
            self._entries.pop(e.key, None)
            return None
        try:
            with np.load(path) as z:
                files = dict(z)
        except (OSError, ValueError):
            self._entries.pop(e.key, None)
            self.counters["coldDrops"] += 1
            return None
        columns = {
            name: {"meta": meta["column_meta"][name],
                   "arrays": {attr: files[f"{ci}:{attr}"] for attr in meta["column_attrs"][name]}}
            for ci, name in enumerate(meta["column_order"])
        }
        snap = {
            "segment_names": meta["segment_names"],
            "num_segments": meta["num_segments"],
            "n_pad": meta["n_pad"],
            "num_docs": meta["num_docs"],
            "num_docs_arr": files["nd:num_docs_arr"],
            "columns": columns,
            "zones": meta.get("zones"),
        }
        nbytes = sum(int(a.nbytes) for a in files.values())
        try:
            os.unlink(path)
        except OSError:
            pass
        e.snap, e.state, e.path, e.meta, e.nbytes = snap, "warm", None, None, nbytes
        self.counters["coldLoads"] += 1
        return snap

    def _remove_payload_locked(self, e: _Entry) -> None:
        if e.path is not None:
            try:
                os.unlink(e.path)
            except OSError:
                pass
        e.snap, e.path, e.meta = None, None, None

    # -- background promotion (cold -> warm ahead of dispatch) -----------
    def prefetch_siblings(self, key: Tuple, table: str) -> None:
        """A promotion of ``table`` just happened: lift its OTHER cold
        entries to warm in the background, so its next segment set pays a
        RAM copy instead of a disk read."""
        with self._lock:
            targets = [k for k, e in self._entries.items() if e.state == "cold" and e.table == table and k != key]
            if not targets:
                return
            for k in targets:
                self._prefetch_q.put(k)
            if self._prefetch_thread is None or not self._prefetch_thread.is_alive():
                self._prefetch_thread = threading.Thread(target=self._prefetch_loop, name="residency-prefetch",
                                                         daemon=True)
                self._prefetch_thread.start()

    def _prefetch_loop(self) -> None:
        while True:
            try:
                k = self._prefetch_q.get(timeout=5.0)
            except queue.Empty:
                return
            try:
                with self._lock:
                    e = self._entries.get(k)
                    if e is not None and e.state == "cold" and self._load_cold_locked(e) is not None:
                        self.counters["prefetches"] += 1
            except Exception:
                pass  # prefetch is best effort by contract

    # -- observability -------------------------------------------------------
    def _tier_totals_locked(self) -> Dict[str, Tuple[int, int]]:
        out = {"hot": [0, 0], "warm": [0, 0], "cold": [0, 0]}
        for e in self._entries.values():
            out[e.state][0] += 1
            out[e.state][1] += e.nbytes
        return {k: (v[0], v[1]) for k, v in out.items()}

    def hot_bytes(self) -> int:
        with self._lock:
            return self._tier_totals_locked()["hot"][1]

    def warm_bytes(self) -> int:
        with self._lock:
            return self._tier_totals_locked()["warm"][1]

    def cold_bytes(self) -> int:
        with self._lock:
            return self._tier_totals_locked()["cold"][1]

    def state_of(self, key: Tuple) -> Optional[str]:
        """The tier of one staging key ("hot", "warm", "cold"), or None."""
        with self._lock:
            e = self._entries.get(key)
            return e.state if e is not None else None

    def counter(self, name: str) -> int:
        with self._lock:
            return self.counters.get(name, 0)

    def pressure(self) -> float:
        """Hot bytes as a fraction of the HBM cap (0.0 when uncapped): the
        ingest governor's residency pool reads it."""
        cap = self.hbm_cap_bytes
        return self.hot_bytes() / cap if cap > 0 else 0.0

    def segment_tiers(self, table: str, segment_names: Sequence[str], raw_match: bool = False) -> Dict[str, str]:
        """The best tier of each named segment ("hot" > "warm" > "cold"),
        for EXPLAIN; a segment no entry holds is absent (the caller
        reports it "unstaged").  ``raw_match`` compares tables without
        their _OFFLINE / _REALTIME suffix; an entry of unknown table
        matches on its segments alone."""
        if raw_match and table:
            table = _raw_table(table)
        rank = {"hot": 0, "warm": 1, "cold": 2}
        wanted = set(segment_names)
        out: Dict[str, str] = {}
        with self._lock:
            for e in self._entries.values():
                etable = _raw_table(e.table) if raw_match and e.table else e.table
                if table and etable and etable != table:
                    continue
                for s in e.segments:
                    if s in wanted and (s not in out or rank[e.state] < rank[out[s]]):
                        out[s] = e.state
        return out

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe tier view: the server's ``status()["residency"]`` and
        ``/debug/residency``."""
        with self._lock:
            totals = self._tier_totals_locked()
            by_table: Dict[str, Dict[str, int]] = {}
            for e in self._entries.values():
                t = by_table.setdefault(e.table, {"hot": 0, "warm": 0, "cold": 0})
                t[e.state] += 1
            cap = self.hbm_cap_bytes
            hot_bytes = totals["hot"][1]
            return {
                "hbmCapBytes": cap,
                "hostCapBytes": self.host_cap_bytes,
                "stageCacheEntries": self.stage_cache_entries,
                "hotTables": totals["hot"][0],
                "hotBytes": hot_bytes,
                "warmTables": totals["warm"][0],
                "warmBytes": totals["warm"][1],
                "coldTables": totals["cold"][0],
                "coldBytes": totals["cold"][1],
                "pinnedTokens": len(self._pins),
                "pressure": round(hot_bytes / cap, 4) if cap > 0 else 0.0,
                "counters": dict(self.counters),
                "byTable": by_table,
            }

    def reset(self) -> None:
        """Drop every tier and zero the counters (the executor's
        ``free_staging``).  Pins are kept: they belong to queries in
        flight, not to entries."""
        with self._guard:
            with self._lock:
                for e in list(self._entries.values()):
                    self._remove_payload_locked(e)
                self._entries.clear()
                self._token_keys.clear()
                self._cache.clear()
                self.ledger.clear()
                for n in self.counters:
                    self.counters[n] = 0
