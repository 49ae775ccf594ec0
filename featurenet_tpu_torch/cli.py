"""Command line for the PyTorch port.

    python -m featurenet_tpu_torch.cli serve --config sprint64 --seed 0 \
        --buckets 1,4,16,64 --port 0 --device cuda
    python -m featurenet_tpu_torch.cli serve --weights w.npz --port 0
    python -m featurenet_tpu_torch.cli train --config sprint64 --device cuda \
        [--total-steps N --global-batch B --eval-batches E \
         --conv-backend pallas|hybrid_dw --seed S]

``--weights`` reads a file written by ``convert.save_npz``. ``serve``
prints one ``{"serving": {...}}`` banner line with the bound port once the
service is warm, serves until SIGTERM/SIGINT (or ``--duration-s``), then
drains and prints ``{"serve_stats": {...}}``.

``train`` prints one ``{"config": {...}}`` line, then the Trainer's JSON
records (``setup``, ``train`` every ``log_every`` steps, ``eval``).
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading


def _parser() -> argparse.ArgumentParser:
    from featurenet_tpu_torch.config import PRESETS

    ap = argparse.ArgumentParser(prog="featurenet_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_srv = sub.add_parser("serve", help="HTTP/1.1 inference service over a "
                                         "continuous batcher")
    src = p_srv.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights", help="port weight file (convert.save_npz); "
                                       "carries its config")
    src.add_argument("--seed", type=int, help="serve random weights from this seed")
    p_srv.add_argument("--config", default="sprint64", choices=sorted(PRESETS),
                       help="preset served with --seed (default sprint64)")
    p_srv.add_argument("--buckets", default="1,4,16,64",
                       help="comma list of dispatch batch sizes (default 1,4,16,64)")
    p_srv.add_argument("--max-wait-ms", type=float, default=5.0, dest="max_wait_ms")
    p_srv.add_argument("--queue-limit", type=int, default=64, dest="queue_limit")
    p_srv.add_argument("--host", default="127.0.0.1")
    p_srv.add_argument("--port", type=int, default=8000,
                       help="HTTP port (0 = ephemeral; printed in the banner)")
    p_srv.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
    p_srv.add_argument("--duration-s", type=float, default=None, dest="duration_s",
                       help="stop after this many seconds (default: until signalled)")

    p_tr = sub.add_parser("train", help="train a classify preset on "
                                        "synthetic parts")
    p_tr.add_argument("--config", default="sprint64", choices=sorted(PRESETS))
    p_tr.add_argument("--total-steps", type=int, dest="total_steps")
    p_tr.add_argument("--global-batch", type=int, dest="global_batch")
    p_tr.add_argument("--eval-batches", type=int, dest="eval_batches")
    p_tr.add_argument("--data-workers", type=int, dest="data_workers")
    p_tr.add_argument("--conv-backend", choices=("pallas", "hybrid_dw"),
                      dest="conv_backend")
    p_tr.add_argument("--seed", type=int)
    p_tr.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _train(args) -> int:
    import dataclasses

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.train.loop import Trainer

    overrides = {k: getattr(args, k) for k in
                 ("total_steps", "global_batch", "eval_batches",
                  "data_workers", "seed") if getattr(args, k) is not None}
    cfg = get_config(args.config, **overrides)
    if args.conv_backend:
        cfg = dataclasses.replace(cfg, arch=dataclasses.replace(
            cfg.arch, conv_backend=args.conv_backend))
    print(json.dumps({"config": dataclasses.asdict(cfg)}, default=str),
          flush=True)
    Trainer(cfg, device=args.device).run()
    return 0


def _serve(args) -> int:
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.serve.batcher import normalize_buckets
    from featurenet_tpu_torch.serve.http import ENDPOINTS, make_server
    from featurenet_tpu_torch.serve.service import InferenceService

    try:
        buckets = normalize_buckets(
            [int(b) for b in args.buckets.split(",") if b.strip()]
        )
    except ValueError:
        raise SystemExit(
            f"serve: --buckets must be comma-separated batch sizes >= 1, "
            f"got {args.buckets!r}"
        )
    if args.weights:
        pred = Predictor.from_npz(args.weights, batch=max(buckets),
                                  device=args.device)
    else:
        pred = Predictor.from_seed(get_config(args.config), args.seed,
                                   batch=max(buckets), device=args.device)
    service = InferenceService(pred, buckets=buckets,
                               max_wait_ms=args.max_wait_ms,
                               queue_limit=args.queue_limit)
    srv = make_server(service, host=args.host, port=args.port)
    server_thread = threading.Thread(target=srv.serve_forever,
                                     name="serve-http", daemon=True)
    server_thread.start()
    print(json.dumps({"serving": {
        "host": srv.server_address[0], "port": srv.server_address[1],
        "buckets": list(buckets), "max_wait_ms": args.max_wait_ms,
        "queue_limit": args.queue_limit, "precision": pred.precision,
        "config": pred.cfg.name, "device": str(pred.device),
        "model_version": pred.model_version, "endpoints": ENDPOINTS,
    }}), flush=True)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait(timeout=args.duration_s)
    srv.shutdown()
    srv.server_close()
    server_thread.join(timeout=10.0)
    st = service.drain()
    print(json.dumps({"serve_stats": st}), flush=True)
    return st["exit_code"]


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    return _train(args) if args.cmd == "train" else _serve(args)


if __name__ == "__main__":
    sys.exit(main())
