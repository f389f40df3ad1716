"""Trace-driven workload replayer.

Production traffic is not uniform: keys are Zipf-hot, sizes are
mixtures, and load breathes on a diurnal curve.  This module generates
a DETERMINISTIC operation trace from a seed — (kind, key, size, at_s)
tuples — and replays it against a GatewayPool, verifying every GET
bit-identical against the last acked body for its key.  Same seed ⇒
byte-identical trace ⇒ a chaos run (bench --replay-phase kills a
gateway mid-window) is exactly reproducible.

Shape knobs and their defaults:

  - keys: Zipf(theta) over ``n_keys`` ranks via a precomputed inverse
    CDF (theta 1.1 ⇒ top key ~22% of ops at 128 keys)
  - sizes: preset mixtures — "small" (metadata-heavy: 80% 512B–8KiB,
    18% 64–256KiB, 2% 1–2MiB) or "multipart" (block-heavy: 50%
    256KiB–1MiB, 35% 2–6MiB, 15% 8–16MiB)
  - arrival: inhomogeneous Poisson-ish pacing with rate(t) =
    base_ops_per_s * (1 + diurnal_amplitude * sin(2πt/period)) — a
    compressed day: peak/trough ratio (1+a)/(1-a)
  - mix: ``read_fraction`` GETs, ``delete_fraction`` DELETEs, the rest
    PUTs (a fresh version body per PUT, deterministic per (key, ver))

The generator is pure (no wall clock, no global RNG): tests assert
trace equality and shape; the runner does the pacing and verification.
"""

from __future__ import annotations

import asyncio
import hashlib
import math
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SIZE_PRESETS = {
    # (probability, lo_bytes, hi_bytes) — probabilities sum to 1
    "small": ((0.80, 512, 8 << 10),
              (0.18, 64 << 10, 256 << 10),
              (0.02, 1 << 20, 2 << 20)),
    "multipart": ((0.50, 256 << 10, 1 << 20),
                  (0.35, 2 << 20, 6 << 20),
                  (0.15, 8 << 20, 16 << 20)),
}


@dataclass
class ReplayConfig:
    seed: int = 20260807
    n_keys: int = 128
    zipf_theta: float = 1.1
    size_preset: str = "small"
    base_ops_per_s: float = 20.0
    diurnal_amplitude: float = 0.6
    diurnal_period_s: float = 8.0
    read_fraction: float = 0.55
    delete_fraction: float = 0.03
    duration_s: float = 10.0
    bucket: str = "replay"


@dataclass
class ReplayStats:
    puts: int = 0
    gets: int = 0
    deletes: int = 0
    not_found: int = 0
    sheds: int = 0
    errors: int = 0
    error_notes: List[str] = field(default_factory=list)
    lats: List[float] = field(default_factory=list)
    behind_s: float = 0.0   # worst pacing debt (replay fell behind)

    def note_error(self, what: str) -> None:
        self.errors += 1
        if len(self.error_notes) < 8:
            self.error_notes.append(what)

    def summary(self) -> dict:
        lats = sorted(self.lats)
        out = {"puts": self.puts, "gets": self.gets,
               "deletes": self.deletes, "not_found": self.not_found,
               "sheds": self.sheds, "errors": self.errors,
               "ops": len(lats), "behind_s": round(self.behind_s, 2)}
        if self.error_notes:
            out["error_notes"] = list(self.error_notes)
        if lats:
            out["p50_ms"] = round(lats[len(lats) // 2] * 1000, 2)
            out["p99_ms"] = round(
                lats[min(len(lats) - 1, int(len(lats) * 0.99))] * 1000, 2)
        return out


def zipf_cdf(n_keys: int, theta: float) -> List[float]:
    """Cumulative weights of rank^-theta — the inverse-CDF table key
    sampling walks (bisect) so the hot set is exactly Zipfian."""
    ws = [1.0 / ((r + 1) ** theta) for r in range(n_keys)]
    total = sum(ws)
    acc, out = 0.0, []
    for w in ws:
        acc += w
        out.append(acc / total)
    return out


def _pick_key(rng: random.Random, cdf: List[float]) -> int:
    import bisect

    return bisect.bisect_left(cdf, rng.random())


def _pick_size(rng: random.Random, preset: str) -> int:
    u = rng.random()
    acc = 0.0
    for prob, lo, hi in SIZE_PRESETS[preset]:
        acc += prob
        if u <= acc:
            return rng.randrange(lo, hi)
    _p, lo, hi = SIZE_PRESETS[preset][-1]
    return rng.randrange(lo, hi)


def generate_ops(cfg: ReplayConfig) -> List[Tuple[str, int, int, float]]:
    """The deterministic trace: [(kind, key_rank, size, at_s), ...]
    sorted by at_s.  kind ∈ {put, get, delete}; size is 0 for get and
    delete.  Pure function of cfg — no wall clock, no global RNG."""
    rng = random.Random(cfg.seed)
    cdf = zipf_cdf(cfg.n_keys, cfg.zipf_theta)
    ops: List[Tuple[str, int, int, float]] = []
    t = 0.0
    while t < cfg.duration_s:
        # inhomogeneous arrivals: thin a homogeneous stream at the
        # diurnal envelope — rate(t) = base * (1 + a*sin(2πt/period))
        rate = cfg.base_ops_per_s * (
            1.0 + cfg.diurnal_amplitude
            * math.sin(2.0 * math.pi * t / cfg.diurnal_period_s))
        rate = max(rate, 0.05 * cfg.base_ops_per_s)
        t += rng.expovariate(rate)
        if t >= cfg.duration_s:
            break
        u = rng.random()
        key = _pick_key(rng, cdf)
        if u < cfg.read_fraction:
            ops.append(("get", key, 0, t))
        elif u < cfg.read_fraction + cfg.delete_fraction:
            ops.append(("delete", key, 0, t))
        else:
            ops.append(("put", key, _pick_size(rng, cfg.size_preset), t))
    return ops


def trace_signature(ops: List[Tuple[str, int, int, float]]) -> str:
    """Stable digest of a trace — two runs of the same config MUST
    produce the same signature (the determinism acceptance check)."""
    h = hashlib.sha256()
    for kind, key, size, at in ops:
        h.update(f"{kind}|{key}|{size}|{at:.6f}\n".encode())
    return h.hexdigest()[:16]


def body_for(cfg: ReplayConfig, key: int, version: int, size: int) -> bytes:
    """Deterministic body for (key, version): seeded 256-byte tile
    repeated to size — cheap to build, unique per version, and
    reproducible so GET verification needs no stored copies."""
    tile_rng = random.Random((cfg.seed, key, version).__hash__())
    tile = bytes(tile_rng.randrange(256) for _ in range(256))
    reps = size // 256 + 1
    return (tile * reps)[:size]


class Replayer:
    """Paces a generated trace against a GatewayPool and verifies the
    chaos-soak invariants inline (acked GETs bit-identical, deletes
    stay deleted) — tolerating typed sheds as non-errors."""

    def __init__(self, cfg: ReplayConfig, pool):
        self.cfg = cfg
        self.pool = pool
        self.ops = generate_ops(cfg)
        self.stats = ReplayStats()
        # key rank -> (version, body) of the last ACKED put; version
        # counts attempts so retried bodies never collide
        self.acked: Dict[int, Tuple[int, bytes]] = {}
        self.deleted: set = set()
        self._versions: Dict[int, int] = {}

    def _key_name(self, rank: int) -> str:
        return f"k{rank:05d}"

    async def _one(self, kind: str, key: int, size: int) -> None:
        cfg, st_ = self.cfg, self.stats
        path = f"/{cfg.bucket}/{self._key_name(key)}"
        t0 = time.perf_counter()
        try:
            if kind == "put":
                ver = self._versions.get(key, 0) + 1
                self._versions[key] = ver
                body = body_for(cfg, key, ver, size)
                st, rb, hdrs = await self.pool.request("PUT", path, body)
                st_.lats.append(time.perf_counter() - t0)
                if st == 200:
                    st_.puts += 1
                    self.acked[key] = (ver, body)
                    self.deleted.discard(key)
                elif st == 503:
                    st_.sheds += 1
                else:
                    st_.note_error(f"PUT k{key}: HTTP {st}")
            elif kind == "get":
                st, got, hdrs = await self.pool.request("GET", path)
                st_.lats.append(time.perf_counter() - t0)
                if st == 200:
                    exp = self.acked.get(key)
                    if exp is not None and got != exp[1]:
                        st_.note_error(f"GET k{key}: body mismatch "
                                       f"(ver {exp[0]})")
                    else:
                        st_.gets += 1
                elif st == 404:
                    if key in self.acked:
                        st_.note_error(f"GET k{key}: 404 after ack")
                    else:
                        st_.not_found += 1
                elif st == 503:
                    st_.sheds += 1
                else:
                    st_.note_error(f"GET k{key}: HTTP {st}")
            else:  # delete
                st, rb, hdrs = await self.pool.request("DELETE", path)
                st_.lats.append(time.perf_counter() - t0)
                if st in (200, 204):
                    st_.deletes += 1
                    self.acked.pop(key, None)
                    self.deleted.add(key)
                elif st == 503:
                    st_.sheds += 1
                else:
                    st_.note_error(f"DELETE k{key}: HTTP {st}")
        except Exception as e:  # noqa: BLE001 — a client-visible failure
            st_.note_error(f"{kind.upper()} k{key}: {e!r}")

    async def run(self, on_op=None) -> ReplayStats:
        """Replay the trace at its generated timestamps (sleeping into
        each op's at_s; pacing debt is recorded, never skipped).
        ``on_op(i, at_s)`` fires before each op — bench uses it to
        trigger the mid-window gateway kill at a deterministic index."""
        t_start = time.monotonic()
        for i, (kind, key, size, at) in enumerate(self.ops):
            now = time.monotonic() - t_start
            if at > now:
                await asyncio.sleep(at - now)
            else:
                self.stats.behind_s = max(self.stats.behind_s, now - at)
            if on_op is not None:
                await on_op(i, at)
            await self._one(kind, key, size)
        return self.stats

    async def verify_all(self) -> int:
        """Read back every acked key; returns mismatches."""
        bad = 0
        for key, (_ver, body) in sorted(self.acked.items()):
            path = f"/{self.cfg.bucket}/{self._key_name(key)}"
            st, got, _h = await self.pool.request("GET", path)
            if st != 200 or got != body:
                bad += 1
                self.stats.note_error(f"verify k{key}: HTTP {st}")
        for key in sorted(self.deleted):
            path = f"/{self.cfg.bucket}/{self._key_name(key)}"
            st, _b, _h = await self.pool.request("GET", path)
            if st != 404:
                bad += 1
                self.stats.note_error(
                    f"verify deleted k{key}: HTTP {st} (expected 404)")
        return bad
