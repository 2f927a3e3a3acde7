"""Per-node dashboard agent.

Reference: dashboard/agent.py + the reporter module
(dashboard/modules/reporter/) — a per-node collector that samples host
and runtime stats and PUSHES them to the control plane, so the head
aggregates from one place instead of fanning RPCs out to every node on
every request (the round-1 head did exactly that fan-out, which cannot
scale past tens of nodes).

Here the agent is an asyncio task inside the nodelet process (one fewer
process per node; the nodelet is already supervised and Python), sampling
every `metrics_report_interval_s` and writing to GCS KV ns="node_stats".
The head's /api/v0/node_stats is then a single KV scan. A standalone
entry point (`python -m ray_tpu_torch.dashboard.agent`) exists for running the
agent out-of-process against any nodelet, mirroring the reference's
separate-agent deployment.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

_CLK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


def sample_host() -> Dict[str, Any]:
    """Host-level stats from /proc (no psutil in-image; ref: the
    reporter's cpu/mem/disk sampling)."""
    out: Dict[str, Any] = {"time": time.time()}
    try:
        with open("/proc/loadavg") as f:
            parts = f.read().split()
            out["load_1m"] = float(parts[0])
            out["load_5m"] = float(parts[1])
    except OSError:
        pass
    try:
        mem = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, _, rest = line.partition(":")
                mem[k] = int(rest.split()[0]) * 1024   # kB -> bytes
        out["mem_total"] = mem.get("MemTotal", 0)
        out["mem_available"] = mem.get("MemAvailable", 0)
    except OSError:
        pass
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()[1:8]
        vals = [int(v) for v in cpu]
        out["cpu_jiffies_total"] = sum(vals)
        out["cpu_jiffies_idle"] = vals[3]
    except OSError:
        pass
    try:
        st = os.statvfs("/")
        out["disk_free"] = st.f_bavail * st.f_frsize
        out["disk_total"] = st.f_blocks * st.f_frsize
    except OSError:
        pass
    return out


async def agent_tick(get_stats, kv_put) -> dict:
    """One sample: runtime stats (from `get_stats()` — in-process
    rpc_node_stats or a remote node_stats call) + host stats, pushed to
    GCS KV under the node id."""
    stats = await get_stats()
    stats["host"] = sample_host()
    stats["collected_at"] = time.time()
    nid = stats["node_id"]
    key = nid.binary() if hasattr(nid, "binary") else bytes.fromhex(str(nid))
    stats["node_id"] = nid.hex() if hasattr(nid, "hex") else str(nid)
    await kv_put("node_stats", key,
                 json.dumps(stats, default=str).encode())
    return stats


async def run_agent(nodelet, gcs_call_async, interval_s: float,
                    stop_fn=None):
    """The nodelet-embedded loop; gcs_call_async(method, **kw) awaits a
    GCS RPC; stop_fn() -> True ends the loop."""
    import asyncio

    async def kv_put(ns, key, value):
        await gcs_call_async("kv_put", ns=ns, key=key, value=value,
                             overwrite=True)

    while not (stop_fn is not None and stop_fn()):
        try:
            await agent_tick(nodelet.rpc_node_stats, kv_put)
        except asyncio.CancelledError:
            raise
        except Exception:   # noqa: BLE001 — sampling must never kill the node
            pass
        await asyncio.sleep(interval_s)


def main():
    """Standalone agent: attach to a nodelet + GCS from outside
    (reference-parity separate-process deployment)."""
    import argparse
    import asyncio

    from ray_tpu_torch.core.rpc import ClientPool

    ap = argparse.ArgumentParser()
    ap.add_argument("--gcs", required=True)
    ap.add_argument("--nodelet", required=True)
    ap.add_argument("--interval", type=float, default=5.0)
    args = ap.parse_args()

    async def run():
        pool = ClientPool()
        gh, gp = args.gcs.rsplit(":", 1)
        nh, np_ = args.nodelet.rsplit(":", 1)
        gcs = pool.get((gh, int(gp)))
        nodelet = pool.get((nh, int(np_)))

        async def get_stats():
            return await nodelet.call("node_stats", timeout=5.0)

        async def kv_put(ns, key, value):
            await gcs.call("kv_put", ns=ns, key=key, value=value,
                           overwrite=True, timeout=5.0)

        while True:
            try:
                await agent_tick(get_stats, kv_put)
            except Exception:   # noqa: BLE001
                pass
            await asyncio.sleep(args.interval)

    asyncio.run(run())


if __name__ == "__main__":
    main()
