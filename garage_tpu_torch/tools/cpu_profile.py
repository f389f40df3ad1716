"""Continuous-CPU-profiler smoke against the running dev cluster.

    python -m garage_tpu_torch.tools.cpu_profile

The port's ``scripts/cpu_profile.py``, run by ``tools/test_smoke.sh``
after ``tools/smoke.py`` (ports from the dev cluster's node configs,
``tools/dev.py``).  Under 32 x 1 MiB PUTs of load it captures a profile
from the REAL daemon and asserts the acceptance invariants:

  - the CLI (`cpu profile`) serves a non-empty collapsed-stack profile
    from the always-on sampler, instantly (history-served, no
    re-sampling wait);
  - the folded stacks name at least the event-loop role, joined to a
    waterfall-taxonomy segment;
  - the sampler's MEASURED self-cost stays under the 2% budget;
  - the `--fold` output is flamegraph.pl-compatible (`stack count`);
  - the cpu_* and scrape-self-cost families render on the live node
    and pass the strict exposition lint.

Prints one JSON line; any failed check exits non-zero.
"""

from __future__ import annotations

import asyncio
import json
import os

from ..utils.promlint import lint_exposition
from ..utils.waterfall import SEGMENTS
from .dev import DevCluster

CPU_FAMILIES = (
    "cpu_profile_samples_total",
    "cpu_busy_ratio",
    "cpu_profiler_overhead_ratio",
    "cpu_profile_trie_nodes",
    "metrics_render_seconds",
    "metrics_gauge_sweep_seconds",
)


async def put_load(dev: DevCluster, rounds: int = 32,
                   concurrency: int = 8) -> None:
    """Drive 1 MiB PUTs through the node0 gateway so the sampler has a
    busy window to fold (hash/EC work releases the GIL, so samples land
    on the real call sites)."""
    import aiohttp

    cli = dev.cli
    kid, sec = dev.create_key("cpuprof-key")
    try:
        cli("bucket", "create", "cpuprof")
    except RuntimeError:
        pass  # bucket survives from a prior run of this script
    cli("bucket", "allow", "cpuprof", "--key", kid,
        "--read", "--write", "--owner")
    payloads = [os.urandom(1 << 20) for _ in range(rounds)]
    sem = asyncio.Semaphore(concurrency)
    errors = 0

    async def one(c, i):
        nonlocal errors
        async with sem:
            st, _, _ = await c.req("PUT", f"/cpuprof/blk-{i}",
                                   body=payloads[i])
            if st != 200:
                errors += 1

    async with aiohttp.ClientSession() as session:
        c = dev.s3(0, kid, sec, session)
        await asyncio.gather(*[one(c, i) for i in range(rounds)])
    assert errors == 0, f"{errors} client errors during profile load"


async def main() -> dict:
    import aiohttp

    dev = DevCluster()
    cli = dev.cli
    await put_load(dev)

    prof = json.loads(cli("cpu", "profile", "--json", "--seconds", "60"))
    assert prof["top"], "live profile served no folded stacks"
    assert prof["samples"] > 0, prof
    roles = {rec["role"] for rec in prof["top"]}
    assert "event-loop" in roles, \
        f"no event-loop samples in the live profile (roles: {roles})"
    for rec in prof["top"]:
        assert rec["segment"] in SEGMENTS, rec
        assert rec["stack"].startswith(f"{rec['role']};{rec['segment']}"), \
            rec
    overhead = prof["overhead_ratio"]
    assert overhead < 0.02, \
        f"sampler overhead {overhead:.4f} breaks the 2% budget"

    # flamegraph.pl-compatible collapsed output: `frame;frame;... N`
    folded = cli("cpu", "profile", "--fold", "--seconds", "60")
    lines = [ln for ln in folded.splitlines() if ln.strip()]
    assert lines, "--fold emitted nothing"
    for ln in lines:
        stack, count = ln.rsplit(" ", 1)
        assert int(count) > 0 and ";" in stack, ln

    # the cpu_* + scrape-self-cost families render on the live gateway
    # and the whole body stays lint-clean
    async with aiohttp.ClientSession() as s:
        async with s.get(
                f"http://127.0.0.1:{dev.admin_ports[0]}/metrics") as r:
            assert r.status == 200
            body = await r.text()
    problems = lint_exposition(body)
    assert not problems, f"live /metrics fails lint: {problems}"
    for fam in CPU_FAMILIES:
        assert fam in body, f"family {fam} missing on live gateway"
    sweeps = [ln for ln in body.splitlines()
              if ln.startswith("metrics_gauge_sweep_seconds{")]
    assert len(sweeps) >= 3, \
        f"expected per-subsystem sweep gauges, got: {sweeps}"

    busy = " ".join(f"{r}={v:.0%}" for r, v in
                    sorted(prof["busy_ratio"].items()))
    print(f"cpu profile smoke ok ({prof['samples']} samples, "
          f"{len(prof['top'])} stacks, roles={sorted(roles)}, "
          f"overhead={overhead * 100:.2f}%, busy: {busy})")
    return {"tool": "cpu_profile", "ok": True, "samples": prof["samples"],
            "stacks": len(prof["top"]), "roles": sorted(roles),
            "overhead_ratio": overhead, "busy_ratio": prof["busy_ratio"]}


if __name__ == "__main__":
    print(json.dumps(asyncio.run(main())))
