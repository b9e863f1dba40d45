"""Plain NumPy reference of the DaeMon KV store's accounting.

What `serve_batch_paged` drives through its store, worked out again from
the mechanism and not from the program: per decode step every tenant
sequence asks for its window of hot KV pages; pages that have landed in
the tenant's local pool hit; a miss sends the critical token (a sub-block
line) and, when the page is not yet in flight, the whole page, on one
memory module's link split into a line channel (`bw_ratio` of the
bandwidth) and a page channel (the rest) (paper §4.1); a page already in
flight is raced by a line only while the line buffer is less used than
the page buffer plus the module's page backlog, and only before the page
has left its queue (§4.2); a landing takes its set's least recently used
way, and evicting a dirty page buys a writeback on the module's reverse
channel unless the page is in flight and its dirty buffer has room
(§4.3). Pages move int8-compressed (half the bytes and one f32 scale per
256 bytes), lines raw (§4.4).

Times are in decode steps. Every arithmetic result is rounded to the
store's clock type, float32, or with `rounding="bfloat16"` to bfloat16:
the lower-precision control of the stall comparison. The tenants'
transactions come first each step (landing, then the probe, so a page
that lands now hits now), then the writebacks of all tenants, then the
requests' scheduling, tenant by tenant and request by request, on the
shared module bank.

`simulate(geometry, batch, prompt_tokens, new_tokens, window_pages,
pages_per_seq)` returns the ledger of one call and, per step, the pages
that landed and the requests that missed (the counts behind the kernels'
byte bounds).
"""
from __future__ import annotations

import numpy as np

BIG = 3.0e38          # "never served" in the scheduler
NEVER = 3.4e38        # empty in-flight entry
SCHEDULED, THROTTLED = 1, 3
LINES_PER_PAGE = 4096 // 64
PAGE_BUF, LINE_BUF = 256, 128
DIRTY_FLUSH_THRESHOLD = 8
RRPV_INSERT, RRPV_HIT = 2.0, 0.0


def _to_f32(x: float) -> float:
    return float(np.float32(x))


def _to_bf16(x: float) -> float:
    bits = np.array([x], dtype=np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return float(bits.astype(np.uint32).view(np.float32)[0])


ROUNDINGS = {"float32": _to_f32, "bfloat16": _to_bf16}


class _Tenant:
    """One sequence: its set-associative page table and its engine's
    in-flight page and line buffers."""

    def __init__(self, sets: int, ways: int):
        self.page = np.full((sets, ways), -1, dtype=np.int64)
        self.age = np.zeros((sets, ways))
        self.ready = np.full((sets, ways), BIG)
        self.dirty = np.zeros((sets, ways), dtype=bool)
        self.rrpv = np.full((sets, ways), 3.0)
        self.pkey = np.full(PAGE_BUF, -1, dtype=np.int64)
        self.pstate = np.zeros(PAGE_BUF, dtype=np.int64)
        self.parr = np.full(PAGE_BUF, NEVER)
        self.pissue = np.full(PAGE_BUF, NEVER)
        self.pdirty = np.zeros(PAGE_BUF, dtype=np.int64)
        self.lkey = np.full(LINE_BUF, -1, dtype=np.int64)
        self.larr = np.full(LINE_BUF, NEVER)
        self.stats = dict.fromkeys(STAT_KEYS, 0.0)


STAT_KEYS = ("sub_block_fetches", "page_moves", "wire_bytes",
             "uncompressed_bytes", "local_hits", "requests", "stall_steps",
             "writeback_bytes", "dirty_evicts", "evictions")


class Store:
    """The tenants and the shared module bank of one call."""

    def __init__(self, geometry: dict, batch: int, rounding="float32"):
        g = geometry
        if g.get("policy", "lru") not in ("lru", "fifo"):
            raise ValueError("the reference knows the lru and fifo policies")
        self.r = ROUNDINGS[rounding]
        r = self.r
        self.sets = g["num_local_pages"] // g["pool_ways"]
        self.ways = g["pool_ways"]
        self.refresh = g.get("policy", "lru") == "lru"
        self.page_tokens = g["page_tokens"]
        self.modules = g.get("num_modules", 1)
        token = float(g["kv_heads"] * g["head_dim"] * 2 * 2)   # K and V, bf16
        raw_page = self.page_tokens * token
        self.line_wire = token
        self.page_raw = raw_page
        self.page_wire = (raw_page / 2 + raw_page / 2 / 256 * 4
                          if g.get("compress_pages", True) else raw_page)
        ratio = g.get("bw_ratio", 0.25)
        budget = g.get("page_budget_per_step", 4)
        self.bw = r(budget * token / (1.0 - ratio))
        self.ratio = r(ratio)
        self.nominal = float(max(1, round(self.page_tokens / budget)))
        m = self.modules
        self.line_busy = [0.0] * m
        self.page_busy = [0.0] * m
        self.wb_busy = [0.0] * m
        self.line_bytes = [0.0] * m
        self.page_bytes = [0.0] * m
        self.wb_bytes = [0.0] * m
        self.tenants = [_Tenant(self.sets, self.ways) for _ in range(batch)]
        self.clock = 0.0

    # ----------------------------------------------------------- residency
    def _transact(self, t: _Tenant, pages, writes):
        """Land the arrived pages, then probe: returns (hits, dirty
        victims' pages, landings)."""
        now = self.clock
        landed = np.nonzero((t.parr <= now) & (t.pstate == SCHEDULED))[0]
        # every set's ways in eviction order, as the table stood before
        score = t.age.copy()
        order = np.argsort(score, axis=1, kind="stable")
        taken = {}
        evicted, n_land = [], 0
        for slot in landed:
            pid = int(t.pkey[slot])
            s = pid % self.sets
            rank = taken.get(s, 0)
            taken[s] = rank + 1
            if rank >= self.ways:
                continue
            w = order[s, rank]
            if t.page[s, w] >= 0:
                t.stats["evictions"] = self.r(t.stats["evictions"] + 1)
                if t.dirty[s, w]:
                    evicted.append(int(t.page[s, w]))
            t.page[s, w], t.age[s, w], t.ready[s, w] = pid, now, now
            t.dirty[s, w], t.rrpv[s, w] = False, RRPV_INSERT
            n_land += 1
        hits = []
        for pid, write in zip(pages, writes):
            s = pid % self.sets
            match = np.nonzero(t.page[s] == pid)[0]
            w = match[0] if len(match) else 0
            hit = bool(len(match)) and t.ready[s, w] <= now
            if hit:
                if self.refresh:
                    t.age[s, w] = max(t.age[s, w], now)
                t.rrpv[s, w] = min(t.rrpv[s, w], RRPV_HIT)
                t.dirty[s, w] |= bool(write)
            hits.append(hit)
        # retire what arrived: its page entry, and the lines of its page
        arrived = set(int(p) for p in t.pkey[landed])
        t.pkey[landed], t.pstate[landed] = -1, 0
        t.parr[landed], t.pissue[landed], t.pdirty[landed] = NEVER, NEVER, 0
        drop = (t.larr <= now) | np.isin(t.lkey // LINES_PER_PAGE,
                                         list(arrived))
        drop &= t.lkey >= 0
        t.lkey[drop], t.larr[drop] = -1, NEVER
        return hits, evicted, n_land

    def _writebacks(self, t: _Tenant, evicted, per_module):
        """§4.3's dirty unit, lane by lane: returns the pages written
        back."""
        n_wb = 0
        for pid in evicted:
            match = np.nonzero(t.pkey == pid)[0]
            found = len(match) > 0
            i = match[0] if found else 0
            cnt = t.pdirty[i] + 1 if found else 0
            over = cnt > DIRTY_FLUSH_THRESHOLD
            t.pdirty[i] = cnt if found and not over else 0
            if found and over:
                t.pstate[i] = THROTTLED
            if not (found and not over):
                per_module[pid % self.modules] += 1
                n_wb += 1
        return n_wb

    # ---------------------------------------------------------- scheduling
    def _serve(self, busy, ready, nbytes, share, gate):
        r = self.r
        start = max(ready, busy)
        done = r(start + r(nbytes / max(r(self.bw * share), 1e-6)))
        return (done if gate else busy), done

    def _request(self, t: _Tenant, pid: int, off: int, hit: bool):
        """One request on the shared bank; returns (line, page, stall)."""
        r, now = self.r, self.clock
        mc = pid % self.modules
        backlog = max(r(self.page_busy[mc] - now), 0.0)
        pressure = r(backlog / r(backlog + self.nominal))
        found = np.nonzero(t.pkey == pid)[0]
        page_found = len(found) > 0
        pidx = found[0] if page_found else 0
        page_room = bool((t.pkey < 0).any())
        line_room = bool((t.lkey < 0).any())
        page_util = r(float((t.pkey >= 0).sum()) / PAGE_BUF)
        line_util = r(float((t.lkey >= 0).sum()) / LINE_BUF)
        send_page = not page_found and page_room
        issued = page_found and t.pissue[pidx] <= now
        race = line_util < r(page_util + pressure) and not issued
        send_line = (race if page_found else True) and line_room
        do_page = not hit and send_page
        do_line = not hit and send_line
        pending = t.parr[pidx] if page_found else BIG
        line_share, page_share = self.ratio, r(1.0 - self.ratio)
        self.line_busy[mc], line_done = self._serve(
            self.line_busy[mc], now, self.line_wire, line_share, do_line)
        self.page_busy[mc], page_done = self._serve(
            self.page_busy[mc], now, self.page_wire, page_share, do_page)
        if do_line:
            self.line_bytes[mc] = r(self.line_bytes[mc] + self.line_wire)
        if do_page:
            self.page_bytes[mc] = r(self.page_bytes[mc] + self.page_wire)
        if do_page:
            i = np.nonzero(t.pkey < 0)[0][0]
            start = r(page_done - r(self.page_wire
                                    / max(r(self.bw * page_share), 1e-6)))
            t.pkey[i], t.pstate[i] = pid, SCHEDULED
            t.parr[i], t.pissue[i], t.pdirty[i] = page_done, start, 0
        if do_line:
            i = np.nonzero(t.lkey < 0)[0][0]
            t.lkey[i] = pid * LINES_PER_PAGE + off
            t.larr[i] = line_done
        served = min(line_done if do_line else BIG,
                     page_done if do_page else BIG, pending)
        if served >= BIG / 2:
            served = r(now + self.nominal)
        stall = 0.0 if hit else max(r(served - now), 0.0)
        return do_line, do_page, stall

    def step(self, pages, offsets, writes):
        """One decode step: pages/offsets/writes are (B, R) lists."""
        r = self.r
        self.clock = r(self.clock + 1.0)
        now = self.clock
        results = [self._transact(t, p, w)
                   for t, p, w in zip(self.tenants, pages, writes)]
        per_module = [0] * self.modules
        n_wbs = [self._writebacks(t, ev, per_module)
                 for t, (_, ev, _) in zip(self.tenants, results)]
        for mc, n in enumerate(per_module):
            if n:
                service = r(self.page_wire / max(self.bw, 1e-6))
                self.wb_busy[mc] = r(max(now, self.wb_busy[mc])
                                     + r(n * service))
                self.wb_bytes[mc] = r(self.wb_bytes[mc]
                                      + r(n * self.page_wire))
        misses = 0
        for t, (hits, _, _), n_wb, p, o in zip(self.tenants, results, n_wbs,
                                               pages, offsets):
            n_line = n_page = 0
            total = 0.0
            for pid, off, hit in zip(p, o, hits):
                line, page, stall = self._request(t, pid,
                                                  off % LINES_PER_PAGE, hit)
                n_line += line
                n_page += page
                total = r(total + stall)
            misses += len(hits) - sum(hits)
            self._fold(t.stats, len(p), n_line, n_page, n_wb, sum(hits),
                       r(total * r(1.0 / len(p))))
        return sum(n for _, _, n in results), misses

    def _fold(self, st, n_req, n_line, n_page, n_wb, n_hit, mean_stall):
        r = self.r
        sub = r(n_line * self.line_wire)
        st["sub_block_fetches"] = r(st["sub_block_fetches"] + n_line)
        st["page_moves"] = r(st["page_moves"] + n_page)
        st["wire_bytes"] = r(r(r(st["wire_bytes"] + sub)
                               + r(n_page * self.page_wire))
                             + r(n_wb * self.page_wire))
        st["uncompressed_bytes"] = r(r(st["uncompressed_bytes"] + sub)
                                     + r((n_page + n_wb) * self.page_raw))
        st["local_hits"] = r(st["local_hits"] + n_hit)
        st["requests"] = r(st["requests"] + n_req)
        st["stall_steps"] = r(st["stall_steps"] + mean_stall)
        st["writeback_bytes"] = r(st["writeback_bytes"]
                                  + r(n_wb * self.page_wire))
        st["dirty_evicts"] = r(st["dirty_evicts"] + n_wb)

    def ledger(self) -> dict:
        out = {k: float(np.sum([t.stats[k] for t in self.tenants],
                               dtype=np.float64)) for k in STAT_KEYS}
        r = self.r
        out["module_bytes"] = [r(r(lb + pb) + wb) for lb, pb, wb in zip(
            self.line_bytes, self.page_bytes, self.wb_bytes)]
        return out


def request_window(pos: int, batch: int, page_tokens: int, window: int,
                   pages_per_seq: int):
    """Each tenant's hot-page window at decode position `pos`: the
    `window` newest pages of its region of the remote pool (newest
    first, clamped at its first page), the token offset of each request
    within its page, and the write flag of the newest page, which the
    position appends to."""
    cur = min(pos // page_tokens, pages_per_seq - 1)
    logical = [max(cur - j, 0) for j in range(window)]
    offs = [pos % page_tokens] + [page_tokens - 1] * (window - 1)
    writes = [True] + [False] * (window - 1)
    pages = [[b * pages_per_seq + lg for lg in logical]
             for b in range(batch)]
    return pages, [offs] * batch, [writes] * batch


def simulate(geometry: dict, batch: int, prompt_tokens: int,
             new_tokens: int, window_pages: int, pages_per_seq: int,
             rounding: str = "float32"):
    """The store over one call's decode positions (the prompt's, then
    the new tokens'). Returns (ledger, landings per step, misses per
    step)."""
    store = Store(geometry, batch, rounding)
    landings, misses = [], []
    for pos in range(prompt_tokens + new_tokens):
        req = request_window(pos, batch, geometry["page_tokens"],
                             window_pages, pages_per_seq)
        n_land, n_miss = store.step(*req)
        landings.append(n_land)
        misses.append(n_miss)
    return store.ledger(), landings, misses
