"""Detection-server CLI, the port's copy of `cough_detector_tpu/cli/serve.py`:
one batched detector on the card, many socket clients (serve/server.py).

    python -m cough_detector_tpu_torch.cli.serve --model ./checkpoints/best_model \
        --port 7717 --streams 256 [--backend native] [--stats-port 0] [--device cuda]

Prints one JSON line once it serves (the bound address and slot capacity),
then a JSON stats line every --stats-interval seconds until SIGINT or
SIGTERM, and a last `{"serving": false, ...}` line. `--device cpu` serves on
the CPU.
"""

from __future__ import annotations

import argparse
import json
import signal
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Multi-stream cough detection server (PyTorch port)")
    p.add_argument("--model", type=str, required=True,
                   help="Checkpoint: a checkpoint directory of the port's "
                        "trainer or a reference .pt")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=7717)
    p.add_argument("--streams", type=int, default=256,
                   help="Stream slot capacity (fixed at start)")
    p.add_argument("--chunk-ms", type=float, default=100.0)
    p.add_argument("--threshold", type=float, default=0.7)
    p.add_argument("--smoothing", type=int, default=3)
    p.add_argument("--debounce", type=float, default=0.5)
    p.add_argument("--buffer-seconds", type=float, default=30.0)
    p.add_argument("--tick-policy", choices=["timer", "eager"], default="timer")
    p.add_argument("--liveness", type=float, default=None,
                   help="Eager policy only: seconds one tenant may stall the "
                        "lockstep tick before the server ticks anyway "
                        "(starved lanes zero-fill). Fires only while "
                        "readiness is asymmetric; an all-idle daemon never "
                        "ticks. Default: one tick period; 'inf' disables")
    p.add_argument("--precision-mode", choices=["high", "serve"], default="high",
                   help='"serve": the classifier\'s bulk convs in TF32 on the '
                        "card, its dense layer and skip projections in FP32 "
                        "(for trained checkpoints; models/layers.py)")
    p.add_argument("--backend", choices=["auto", "python", "native"], default="auto",
                   help="Socket tier: native = the C++ epoll plane (no Python "
                        "in the per-frame path), python = the portable tier, "
                        "auto = native when its library builds")
    p.add_argument("--h2d-dtype", choices=["float32", "int16", "mulaw"], default="float32",
                   help="Per-tick host-to-device batch format: int16 = 16-bit "
                        "PCM (half the upload bytes), mulaw = 8-bit μ-law "
                        "(a quarter; approximate, docs/PARITY.md)")
    p.add_argument("--ingest-workers", type=int, default=1,
                   help="C++ epoll I/O threads (native backend); connections "
                        "partition across them, events are the same at any count")
    p.add_argument("--stats-interval", type=float, default=10.0)
    p.add_argument("--stats-port", type=int, default=None,
                   help="Serve GET /healthz and /stats (JSON) on this HTTP "
                        "port (0 = ephemeral; the address is in the readiness "
                        "line). /healthz turns 200 once the daemon accepts clients")
    p.add_argument("--max-seconds", type=float, default=None,
                   help="Exit after serving this long (smoke tests, supervisors)")
    p.add_argument("--compile-cache", type=str, default=None,
                   help="Accepted for command-line compatibility with the JAX "
                        "CLI and ignored: the port caches its one compiled "
                        "kernel by source hash under build/kernels/")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' to serve on the CPU")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from ..serve import DetectionServer
    from ..stream.detector import _load_checkpoint

    variables, config = _load_checkpoint(args.model)
    chunk_size = int(config.features.sample_rate * args.chunk_ms / 1000.0)
    server = DetectionServer(
        variables=variables,
        config=config,
        device=args.device,
        host=args.host,
        port=args.port,
        num_streams=args.streams,
        chunk_size=chunk_size,
        confidence_threshold=args.threshold,
        smoothing_window=args.smoothing,
        debounce_seconds=args.debounce,
        tick_policy=args.tick_policy,
        liveness_seconds=args.liveness,
        buffer_seconds=args.buffer_seconds,
        precision_mode=args.precision_mode,
        backend=args.backend,
        h2d_dtype=args.h2d_dtype,
        ingest_workers=args.ingest_workers,
    )
    # The sidecar binds before the warm tick so orchestrators can poll
    # /healthz through the start; it turns ready once clients are served.
    stats_http = None
    if args.stats_port is not None:
        from ..serve.stats_http import StatsHttpServer

        stats_http = StatsHttpServer(server.stats, host=args.host, port=args.stats_port)

    # Supervisors stop daemons with SIGTERM: route it through the clean
    # path of Ctrl-C (threads joined, sockets closed, final stats line),
    # and put the previous handler back on the way out, so main() can be
    # embedded (tests, supervisors) without leaking a raising handler.
    def _sigterm(signum, frame):
        raise KeyboardInterrupt

    try:
        prev_sigterm = signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:  # not the main thread: Ctrl-C only
        prev_sigterm = None
    try:
        # The guard covers start() and shutdown too: a signal may arrive
        # during the warm tick or between start() and the loop, and stop()
        # is safe after a partial start.
        try:
            server.start()
            # --max-seconds bounds serving time, counted from here.
            deadline = time.time() + args.max_seconds if args.max_seconds else None
            if stats_http is not None:
                stats_http.set_ready(True)
            # The native plane binds in start(), so the address is read now.
            host, port = server.address[0], server.address[1]
            print(json.dumps({
                "serving": True, "host": host, "port": port,
                "streams": args.streams, "chunk_ms": args.chunk_ms,
                "model_type": config.model.model_type,
                "backend": server.backend,
                "h2d_dtype": server.h2d_dtype,
                "device": args.device,
                **({"stats_http": list(stats_http.address)} if stats_http is not None else {}),
            }), flush=True)
            while deadline is None or time.time() < deadline:
                left = deadline - time.time() if deadline else args.stats_interval
                time.sleep(max(0.01, min(args.stats_interval, left)))
                print(json.dumps(server.stats()), flush=True)
        except KeyboardInterrupt:
            pass
        finally:
            # Ignore a second SIGTERM while stop() joins threads: it must
            # not raise past this guard.
            if prev_sigterm is not None:
                signal.signal(signal.SIGTERM, signal.SIG_IGN)
            if stats_http is not None:
                stats_http.set_ready(False)  # drain: /healthz 503 first
                stats_http.stop()
            server.stop()
    finally:
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
    print(json.dumps({"serving": False, **server.stats()}), flush=True)


if __name__ == "__main__":
    main()
