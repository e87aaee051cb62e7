"""Serving on the PyTorch port: two continuous-batching engines, one
SIGKILLed mid-stream (the twin of ``examples/serve_llm.py``).

Serving runs on a lease-driven request plane: clients
``rpush`` request ids onto ``serve/q/*`` and engines lease them with an
atomic compare-and-take, so any number of engine workers can share one
queue without double-serving.  The whole crash story is the lease
lifecycle — submit, take, fence, reap, re-take — and it runs on a plain
KV, no model required:

>>> import time
>>> from repro_torch.serve import request_plane as rp
>>> from repro_torch.storage import KVStore, ObjectStore
>>> kv, store = KVStore(num_shards=1), ObjectStore()
>>> rp.submit(store, kv, "r1", [1, 2, 3])           # body first, then id
'serve/done/r1'
>>> [r for r, body in rp.lease_requests(store, kv, "e-A", 4)]
['r1']
>>> rp.lease_requests(store, kv, "e-B", 4)          # live lease: e-B waits
[]
>>> rp.reap_expired(store, kv, now=time.time() + 99)   # e-A dies; lapse reaped
1
>>> [r for r, body in rp.lease_requests(store, kv, "e-B", 4)]  # re-served
['r1']
>>> kv.get(rp.lease_key("r1"))["term"]   # fenced takeover: term strictly grows
2

Re-serving is *safe* because generation is deterministic per request: the
sampling key is derived from the request id (``rp.request_seed``), so e-B
reproduces byte-identical tokens and the first-writer-wins result publish
makes the duplicate a no-op.

Below, the real thing: two ``repro_torch.launch.serve`` engine
subprocesses over shared ``FileKVStore``/``FileBackend`` directories, a
client that watches tokens stream in *before* completion, and a SIGKILL
landing on engine A while its slots are mid-decode (B is started while A
serves, so A surely holds leases then).  Engine B reaps A's lapsed leases
and finishes the job: every request completes exactly once.
The engines run on the GPU (the hand-written attention kernels) unless
``--device cpu`` is given; they never fall back to the CPU.

Run:  PYTHONPATH=src python examples_torch/serve_llm.py [--device cpu]
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
N_REQ = 8


def _start_engine(kv_root: str, obj_root: str, engine_id: str, device: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=_SRC)
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "repro_torch.launch.serve",
            "--arch", "qwen3-32b", "--reduced", "--device", device,
            "--kv-root", kv_root, "--obj-root", obj_root,
            "--engine-id", engine_id,
            "--new-tokens", "24", "--decode-chunk", "1",
            "--lease-timeout", "1.0", "--idle-timeout", "8",
        ],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
    )
    return proc


def _ready(proc: subprocess.Popen) -> None:
    line = proc.stdout.readline().strip()
    assert line.startswith("READY"), f"engine failed to start: {line!r}"


def main(argv=None) -> dict:
    """-> {"results": {request id: result}, "served": {engine: count},
    "tokens": tokens published, "seconds": from submit to the last
    result, "outstanding_at_kill": requests not done when A died}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="the engines' device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.serve import request_plane as rp
    from repro_torch.storage import FileBackend, FileKVStore, ObjectStore

    with tempfile.TemporaryDirectory() as root:
        kv_root = os.path.join(root, "kv")
        obj_root = os.path.join(root, "obj")
        kv = FileKVStore(kv_root, num_shards=2)
        store = ObjectStore(backend=FileBackend(obj_root))

        victim = _start_engine(kv_root, obj_root, "engine-A", args.device)
        _ready(victim)
        # B starts now and is READY seconds later, while A serves: A holds
        # live leases when it dies (with both up first, B may lease every
        # request before A holds one, and then the kill re-serves nothing)
        survivor = _start_engine(kv_root, obj_root, "engine-B", args.device)
        print("engine-A up, engine-B starting (separate processes, shared directories)")

        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        ids = [f"req-{i:03d}" for i in range(N_REQ)]
        for r in ids:
            rp.submit(store, kv, r, rng.integers(0, 1000, size=6).tolist())
        print(f"submitted {N_REQ} requests")

        # SIGKILL engine A while it holds a live lease on an unfinished
        # request — its slots are mid-decode (the JAX example kills at the
        # first result, which a fast engine may have passed entirely)
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            done = store.exists_many([rp.done_key(r) for r in ids])
            held = [r for r in ids if rp.done_key(r) not in done
                    and (kv.get(rp.lease_key(r)) or {}).get("engine") == "engine-A"]
            if held or len(done) == N_REQ:
                break
            if victim.poll() is not None:
                raise RuntimeError("engine-A exited: " + victim.stdout.read()[-2000:])
            time.sleep(0.01)
        victim.kill()
        victim.wait()
        done = store.exists_many([rp.done_key(r) for r in ids])
        outstanding = N_REQ - len(done)
        print(f"SIGKILLed engine-A with {outstanding} requests outstanding")
        _ready(survivor)

        # tokens stream as rpush chunks: watch a still-pending request
        # arrive in pieces (served by B — possibly a re-serve of one of
        # A's orphaned leases)
        pending = [r for r in ids if rp.done_key(r) not in done]
        if pending:
            chunks = list(rp.stream_result(store, kv, pending[-1], timeout_s=60.0))
            print(
                f"{pending[-1]} streamed in {len(chunks)} chunks "
                f"({sum(len(c) for c in chunks)} tokens) before its done record"
            )

        # engine B reaps A's lapsed leases and re-serves: nothing is lost,
        # first-writer-wins publish means nothing is duplicated
        results = rp.get_results(store, ids, timeout_s=120.0)
        seconds = time.perf_counter() - t0
        by_engine: dict = {}
        for r in ids:
            by_engine.setdefault(results[r]["engine"], []).append(r)
        served = {e: len(v) for e, v in sorted(by_engine.items())}
        assert len(results) == N_REQ, served
        assert all(results[r]["tokens"] for r in ids)
        tokens = sum(len(results[r]["tokens"]) for r in ids)
        print(f"all {N_REQ} requests completed exactly once: {served}")
        print(f"{tokens} tokens in {seconds:.1f} s from submit to the last result "
              f"({tokens / seconds:.1f} tok/s, a SIGKILL and a re-serve included)")

        survivor.wait(timeout=60)
        # the survivor's exit lines: its kernel launches and its stats
        for line in survivor.stdout.read().splitlines():
            if line.startswith("launches ") or "served" in line:
                print(line)
        kv.close()
    return {"results": results, "served": served, "tokens": tokens, "seconds": seconds,
            "outstanding_at_kill": outstanding}


if __name__ == "__main__":
    main()
