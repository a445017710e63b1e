"""Multi-tenant pkt/s of two source trees, timed in turns on one card.

Serves the tenant pool of ``benchmarks/multitenant_bench.py`` as
``chip_smoke.tenant_pool`` builds it (its six BNN shapes in turn, weights
from seeds, admitted in merged mode on the chip that benchmark sizes)
through ``SwitchScheduler.run`` at chunk 1024, in the cases
where the merged register file is past the op-table kernel's shared route:
32 tenants ``interleave`` and ``concat`` on the op-table backend, 32 tenants
``concat`` on the packed backend (its 916 x 32-word layer), and 128 tenants
``interleave`` on the op-table backend.  Each case runs once on its first
8 chunks (kernel builds, plans and uploads) and is then timed over the whole
stream; the line gives ``packets_per_second`` and each kernel's launches by
route.

Each tree runs in a process of its own, from the tree's root with
``PYTHONPATH=<tree>/src``, so each imports and builds its own
``repro_torch`` and its own ``chip_smoke.py``'s pool, in the order given:
pass the parent and the change as ``--trees PARENT CHANGE --order ABBA`` to
time parent, change, change, parent.  Nothing here is specific to a route,
so it runs on trees from before and after a route was added::

    python tools/multitenant_turns.py --trees tree_check/parent . --out mt_turns.jsonl

Each line it prints (and appends to ``--out``) is one JSON object per tree
and run; ``--device cpu`` rehearses it on the plain versions.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

WARM_CHUNKS = 8
CASES = ((32, "interleave", "jnp"), (32, "concat", "jnp"), (32, "concat", "packed"), (128, "interleave", "jnp"))


def worker(packets: int, device: str) -> dict:
    """Every case on this process's ``repro_torch``; returns the record."""
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.dataplane import traffic
    from repro_torch.kernels import optable_exec, packed_layer

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("multitenant_turns: no CUDA device")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out = {"tree": os.environ.get("PYTHONPATH", ""), "device": name, "cases": {}}
    chunk = chip_smoke.MT_CHUNK
    pools = {}
    for count, layout, backend in CASES:
        if count not in pools:
            pool = chip_smoke.tenant_pool(count)
            pools[count] = (pool.fleet.scheduler(quantum=chunk),
                            *traffic.mixed_tenant_generate(pool.specs, packets, seed=count))
        sched, tids, bits = pools[count]

        def arrivals(n):
            return ((tids[i:i + chunk], bits[i:i + chunk]) for i in range(0, n, chunk))

        kw = dict(mode="merged", merged=layout, backend=backend, chunk_size=chunk, device=dev)
        sched.run(arrivals(WARM_CHUNKS * chunk), **kw)
        counters = (optable_exec.optable_run, packed_layer.packed_layer)
        before = [dict(fn.launches_by_route) for fn in counters]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        res = sched.run(arrivals(len(tids)), **kw)
        routes = {fn.__name__: {p: n - b[p] for p, n in fn.launches_by_route.items() if n - b[p]}
                  for fn, b in zip(counters, before)}
        served = int(np.sum([st.served for st in res.tenants]))
        out["cases"][f"{count} tenants {layout} {'op-table' if backend == 'jnp' else backend}"] = {
            "packets": res.packets, "served": served, "seconds": res.seconds,
            "packets_per_second": res.packets_per_second, "launches_by_route": routes}
    return out


def run_turns(script: str, trees: list, order: str, worker_args: list, out: str | None) -> int:
    """Run ``script --worker *worker_args`` once per letter of ``order``
    (A names ``trees[0]``), each in a process of its own from that tree's
    root with ``PYTHONPATH=<tree>/src`` and nothing of this tree on the
    path; print (and append to ``out``) each run's last stdout line, a JSON
    record, with the turn, letter and wall seconds added."""
    for turn, letter in enumerate(order):
        tree = os.path.abspath(trees[ord(letter) - ord("A")])
        env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
        t0 = time.perf_counter()
        # Run from the tree's root by path (its own copy of the script may
        # not exist): the worker imports that tree's modules.
        argv = [os.path.abspath(script), "--worker", *worker_args]
        code = f"import runpy, sys; sys.argv = {argv!r}; runpy.run_path(sys.argv[0], run_name='__main__')"
        proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, cwd=tree)
        if proc.returncode:
            sys.stderr.write(proc.stdout + proc.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec.update(turn=turn, letter=letter, wall_s=time.perf_counter() - t0)
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
            with open(out, "a") as f:
                f.write(line + "\n")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", help="source trees (directories holding src/repro_torch)")
    ap.add_argument("--order", default="ABBA", help="letters naming --trees in turn (A is the first)")
    ap.add_argument("--packets", type=int, default=1 << 19)
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for a rehearsal on the plain versions")
    ap.add_argument("--out", help="append each run's JSON line to this file")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.packets, args.device)))
        return 0
    return run_turns(__file__, args.trees, args.order, ["--packets", str(args.packets), "--device", args.device],
                     args.out)


if __name__ == "__main__":
    sys.exit(main())
