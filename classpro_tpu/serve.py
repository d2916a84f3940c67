"""Persistent warm-engine service.

The reference binary cold-starts in ~1 s (ClassPro.c:503 main is plain
precompiled C), while a run-once `cli classify` starts JAX and compiles
(or loads from the persistent cache) one device program per (R, max_m)
shape.  ``cli serve`` pays that once per service lifetime: the daemon
keeps the process-global AOT executable cache (`tpu.engine._AOT_CACHE`)
warm — the rel program takes its model tables as RUNTIME arguments, so
one executable per shape serves every dataset/model — and successive
``cli classify --server`` jobs attach over a unix socket.  Whether the
daemon still pays for itself beside the persistent compile cache is
decided from chip_smoke.py's cold/warm numbers (ROADMAP 3b).

Protocol: one JSON object per line, one reply line per request.
  {"cmd": "ping"}                      -> {"ok": true, "pid": N,
                                           "warm_shapes": [[R, m], ...]}
  {"cmd": "classify", "source": ..., "output": ...,
   "fastk_root"|"coverage"|"read_len"|"model"|"batch_size"|"threads"|
   "warmup" optional}                  -> {"ok": true, "wall_s": S,
                                           "reads": N, "kmers": N,
                                           "guard_flagged": N, ...}
  {"cmd": "stats"}                     -> {"ok": true, "jobs": N, ...}
  {"cmd": "shutdown"}                  -> {"ok": true}

Jobs run serially (one engine stream at a time on the one card; the
reference's own threading is intra-job, ClassPro.c:574-578).
"""

from __future__ import annotations

import json
import os
import socket
import sys
import time


def _warm_shapes() -> list[list[int]]:
    from classpro_tpu.tpu.engine import _AOT_CACHE

    return sorted({(k[0], k[1]) for k in _AOT_CACHE})


def _do_classify(req: dict) -> dict:
    from classpro_tpu.io.classfile import write_class
    from classpro_tpu.tpu.engine import classify_file_tpu

    source = req["source"]
    root = source
    for ext in (".fastq", ".fasta", ".fq", ".fa",
                ".fastq.gz", ".fasta.gz", ".fq.gz", ".fa.gz"):
        if source.endswith(ext):
            root = source[: -len(ext)]
            break
    out = req.get("output") or root + ".class"
    t0 = time.time()
    recs = classify_file_tpu(
        source, req.get("fastk_root") or root,
        coverage=int(req.get("coverage", 0)),
        read_len=int(req.get("read_len", 20000)),
        model_path=req.get("model"),
        batch_size=int(req.get("batch_size", 200)),
        threads=int(req.get("threads", 0)),
        warmup=bool(req.get("warmup", False)))
    n = 0

    def counted():
        nonlocal n
        for r in recs:
            n += 1
            yield r

    write_class(out, counted())
    return {"ok": True, "output": out, "reads": n,
            "wall_s": round(time.time() - t0, 2),
            "warm_shapes": _warm_shapes()}


def serve(sock_path: str, warmup_root: str | None = None,
          warmup_shapes: tuple = (), verbose: bool = False) -> int:
    """Run the daemon until a shutdown request (or SIGTERM)."""
    try:
        os.unlink(sock_path)
    except OSError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    srv.listen(8)

    stats = {"jobs": 0, "errors": 0, "started": time.time()}
    if warmup_root:
        # pre-build before taking traffic: one engine over the given
        # dataset root warms the requested (or default) shapes into the
        # process-global cache
        from classpro_tpu.estimation import build_global_model
        from classpro_tpu.io.fastk import load_histogram
        from classpro_tpu.tpu.engine import TpuEngine

        gm = build_global_model(load_histogram(warmup_root))
        eng = TpuEngine(gm, verbose=verbose)
        t0 = time.time()
        eng.warmup(warmup_shapes or ((256, 128), (256, 192)))
        if verbose:
            print(f"serve: warmed {_warm_shapes()} in "
                  f"{time.time() - t0:.0f}s", file=sys.stderr)
    if verbose:
        print(f"serve: listening on {sock_path}", file=sys.stderr)
    print("READY", flush=True)    # startup handshake for supervisors

    while True:
        conn, _ = srv.accept()
        try:
            f = conn.makefile("rwb")
            line = f.readline()
            if not line:
                continue
            try:
                req = json.loads(line)
                cmd = req.get("cmd")
                if cmd == "ping":
                    rep = {"ok": True, "pid": os.getpid(),
                           "warm_shapes": _warm_shapes()}
                elif cmd == "stats":
                    rep = dict(ok=True, warm_shapes=_warm_shapes(),
                               uptime_s=round(time.time()
                                              - stats["started"], 1),
                               **{k: v for k, v in stats.items()
                                  if k != "started"})
                elif cmd == "classify":
                    stats["jobs"] += 1
                    rep = _do_classify(req)
                elif cmd == "shutdown":
                    rep = {"ok": True}
                else:
                    rep = {"ok": False, "error": f"unknown cmd {cmd!r}"}
            except Exception as e:   # job errors must not kill the daemon
                stats["errors"] += 1
                rep = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            f.write(json.dumps(rep).encode() + b"\n")
            f.flush()
            if req.get("cmd") == "shutdown" and rep.get("ok"):
                break
        finally:
            conn.close()
    srv.close()
    try:
        os.unlink(sock_path)
    except OSError:
        pass
    return 0


def request(sock_path: str, req: dict, timeout: float = 0.0) -> dict:
    """Send one request; return the parsed reply.  ``timeout`` bounds
    CONNECT only — a classify job legitimately runs for minutes, so the
    reply read is unbounded by default."""
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    if timeout > 0:
        c.settimeout(timeout)
    c.connect(sock_path)
    c.settimeout(None)
    f = c.makefile("rwb")
    f.write(json.dumps(req).encode() + b"\n")
    f.flush()
    line = f.readline()
    c.close()
    if not line:
        raise RuntimeError(f"server at {sock_path} closed the connection "
                           f"without replying")
    return json.loads(line)
