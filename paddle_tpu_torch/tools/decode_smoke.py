#!/usr/bin/env python
"""Continuous-batching decode smoke of the port: one GRU LM
(``serving.decode_models.gru_lm``) behind ``EngineManager`` + ``FrontDoor``
serving concurrent ragged generation clients, then the four properties of
decode serving, end to end:

* **no cross-request leakage**: every concurrently decoded request's
  token ids are bit-identical to a solo engine (same seed, batch 1)
  generating that prompt alone;
* **no steady-state compiles**: after the load-time warmup the engine's
  ``fresh_compiles_since_warmup`` stays 0 through all the join / retire /
  backfill churn;
* **causal traces**: a sampled request's trace assembles under the
  reference's ``tools/trace_tool.py --strict`` (front-door span -> decode
  request span, no broken parent chains);
* **a soak through a hot swap**: a short concurrent soak with a mid-soak
  ``swap_decode`` (new parameters, canary-gated) keeps the admitted p99
  under its bound, and the replacement engine pays no fresh compile.

One ``POST /v1/generate`` through ``FleetHTTPServer`` on 127.0.0.1 rides
along.  Prints one JSON summary line; any failure exits non-zero.  The
telemetry (``decode_<pid>.jsonl``, ``fleet_<pid>.jsonl``) goes to
``$PADDLE_TPU_TELEMETRY_DIR``, or to a temporary directory removed at the
end when it is not set.

    python paddle_tpu_torch/tools/decode_smoke.py          # on CUDAPlace(0)
    python paddle_tpu_torch/tools/decode_smoke.py --cpu    # on the CPU
"""
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

EOS = 0
MAX_SEQ = 32
BATCH = 8
CLIENTS = 8
PER_CLIENT = 3
SOAK_S = 4.0
SOAK_P99_BOUND_S = 2.0


def fail(msg):
    print(f"DECODE SMOKE FAIL: {msg}", file=sys.stderr)
    return 1


def ragged_requests(n, rs, vocab):
    return [{"prompt": rs.randint(1, vocab, size=rs.randint(1, 11)).astype(np.int64),
             "max_new": int(rs.randint(4, 17))} for _ in range(n)]


def sampled_trace_id(tel_dir):
    """trace_id of one retired request record in decode_*.jsonl."""
    for path in sorted(glob.glob(os.path.join(tel_dir, "decode_*.jsonl"))):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except ValueError:
                    continue
                if r.get("kind") == "request" and r.get("trace_id"):
                    return r["trace_id"]
    return None


def run(place):
    from paddle_tpu_torch.serving import (DecodeEngine, EngineManager,
                                          FleetHTTPServer, FrontDoor)
    from paddle_tpu_torch.serving import decode_models as zoo

    summary = {"place": str(place)}
    prefill_func, step_func, _ = zoo.gru_lm()
    rs = np.random.RandomState(0)
    reqs = ragged_requests(CLIENTS * PER_CLIENT, rs, zoo.VOCAB)

    # the solo engine: same seed, one request at a time at batch 1; what
    # it emits is what the shared engine must reproduce bit for bit
    solo = DecodeEngine(prefill_func, step_func, eos_id=EOS, max_seq_len=MAX_SEQ,
                        max_batch_size=1, seed=11, name="decode-solo", place=place)
    try:
        expected = [np.asarray(solo.generate(r["prompt"], r["max_new"]).tokens) for r in reqs]
    finally:
        solo.close(drain=False)

    mgr = EngineManager(place=place)
    mgr.load_decode("lm", prefill_func, step_func, eos_id=EOS, max_seq_len=MAX_SEQ,
                    max_batch_size=BATCH, seed=11, default_timeout_s=60.0)
    fd = FrontDoor(mgr, default_timeout_s=60.0)
    try:
        # ---- concurrent ragged clients through the front door
        got = [None] * len(reqs)
        errors = []

        def client(c):
            try:
                for j in range(PER_CLIENT):
                    i = c * PER_CLIENT + j
                    r = fd.generate("lm", reqs[i]["prompt"], max_new_tokens=reqs[i]["max_new"])
                    got[i] = np.asarray(r.tokens)
            except Exception as e:  # noqa: BLE001
                errors.append(f"client {c}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(c,)) for c in range(CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        if errors:
            return fail("concurrent clients errored:\n  " + "\n  ".join(errors[:10]))
        leaks = sum(1 for g, w in zip(got, expected) if g is None or not np.array_equal(g, w))
        summary.update(requests=len(reqs), leaked=leaks)
        if leaks:
            return fail(f"{leaks}/{len(reqs)} concurrent request(s) differ from the solo "
                        f"engine: cross-request leakage or scheduling-dependent sampling")

        # ---- one HTTP round over the same fleet
        import urllib.request
        with FleetHTTPServer(fd) as srv:
            body = json.dumps({"model": "lm", "prompt": reqs[0]["prompt"].tolist(),
                               "max_new_tokens": reqs[0]["max_new"]}).encode()
            http_req = urllib.request.Request(srv.address + "/v1/generate", data=body,
                                              headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(http_req, timeout=60) as resp:
                out = json.loads(resp.read())
        http_toks = np.asarray(out["tokens"])
        summary["http_reason"] = out.get("reason")
        if not np.array_equal(http_toks.reshape(expected[0].shape), expected[0]):
            return fail(f"POST /v1/generate tokens {http_toks.tolist()} differ from the solo "
                        f"engine's")

        # ---- no steady-state compile after all that churn
        fresh = mgr.decode_engine("lm").fresh_compiles_since_warmup
        summary["fresh_compiles_after_churn"] = fresh
        if fresh:
            return fail(f"{fresh} fresh compile(s) after warmup: the (phase x batch x seqlen) "
                        f"warmup does not cover steady-state membership churn")

        # ---- the sampled request's trace assembles cleanly
        tel_dir = os.environ["PADDLE_TPU_TELEMETRY_DIR"]
        tid = sampled_trace_id(tel_dir)
        summary["sampled_trace"] = tid
        if tid is None:
            return fail(f"no request record with a trace_id in {tel_dir}/decode_*.jsonl")
        proc = subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "trace_tool.py"), tel_dir,
             "--trace", tid, "--strict", "--min-spans", "2"],
            capture_output=True, text=True)
        if proc.returncode != 0:
            return fail(f"trace_tool --strict failed on request trace {tid}:\n"
                        f"{proc.stdout}\n{proc.stderr}")

        # ---- a soak with a mid-soak hot swap; the admitted p99 holds
        latencies, soak_errors = [], []
        lock = threading.Lock()
        stop_at = time.monotonic() + SOAK_S

        def soak_client(c):
            r = np.random.RandomState(100 + c)
            while time.monotonic() < stop_at:
                prompt = r.randint(1, zoo.VOCAB, size=r.randint(1, 9)).astype(np.int64)
                t0 = time.perf_counter()
                try:
                    fd.generate("lm", prompt, max_new_tokens=int(r.randint(2, 9)))
                except Exception as e:  # noqa: BLE001
                    with lock:
                        soak_errors.append(f"{type(e).__name__}: {e}")
                    continue
                with lock:
                    latencies.append(time.perf_counter() - t0)

        threads = [threading.Thread(target=soak_client, args=(c,)) for c in range(CLIENTS)]
        for t in threads:
            t.start()
        time.sleep(SOAK_S / 2.0)
        slot = mgr.swap_decode("lm", prefill_func, step_func, eos_id=EOS, max_seq_len=MAX_SEQ,
                               max_batch_size=BATCH, seed=23, default_timeout_s=60.0)
        for t in threads:
            t.join(timeout=120.0)
        if soak_errors:
            return fail("soak errors:\n  " + "\n  ".join(soak_errors[:10]))
        if not latencies:
            return fail("the soak admitted no generation")
        p99 = float(np.percentile(np.array(latencies), 99))
        fresh_swap = mgr.decode_engine("lm").fresh_compiles_since_warmup
        summary.update(soak_admitted=len(latencies), soak_p99_ms=round(p99 * 1e3, 2),
                       soak_bound_ms=SOAK_P99_BOUND_S * 1e3,
                       mid_soak_swap_version=slot.version, swap_fresh_compiles=fresh_swap)
        if p99 >= SOAK_P99_BOUND_S:
            return fail(f"admitted p99 {p99 * 1e3:.1f} ms >= {SOAK_P99_BOUND_S * 1e3:.0f} ms "
                        f"through the mid-soak hot swap")
        if fresh_swap:
            return fail(f"the replacement engine paid {fresh_swap} fresh compile(s) after "
                        f"the swap")
        summary["swaps"] = mgr.stats().get("swaps", 0)
        if summary["swaps"] < 1:
            return fail("the manager recorded no swap")
    finally:
        mgr.close()
    print(json.dumps(summary))
    return 0


def main(argv) -> int:
    on_cpu = "--cpu" in argv
    made = None
    if not os.environ.get("PADDLE_TPU_TELEMETRY_DIR"):
        made = tempfile.mkdtemp(prefix="decode_smoke_")
        os.environ["PADDLE_TPU_TELEMETRY_DIR"] = made
    try:
        import paddle_tpu_torch as pt
        return run(pt.CPUPlace() if on_cpu else pt.CUDAPlace(0))
    finally:
        if made is not None:
            shutil.rmtree(made, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
