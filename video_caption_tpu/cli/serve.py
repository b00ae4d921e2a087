"""uvicorn launcher (reference analog: scripts/start_app_stack.ps1 backend
half): ``python -m video_caption_tpu.cli.serve [--host H] [--port P]``."""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    from video_caption_tpu.server.settings import SETTINGS

    p = argparse.ArgumentParser()
    p.add_argument("--host", default=SETTINGS.host)
    p.add_argument("--port", type=int, default=SETTINGS.port)
    p.add_argument("--warmup", action="store_true",
                   help="compile the default engine before accepting requests")
    args = p.parse_args(argv)

    from video_caption_tpu.env import assert_accelerator_or_cpu_requested

    assert_accelerator_or_cpu_requested()
    if args.warmup:
        from video_caption_tpu.config import serving_inference_config
        from video_caption_tpu.server.services.model_registry import MODEL_REGISTRY

        # must match the config the request path builds (serving presets,
        # inference_service.request_to_config) — the registry keys engines by
        # the FULL config hash, so warming the core-default config would leave
        # the actual serving engine cold
        engine = MODEL_REGISTRY.get_engine(serving_inference_config())
        secs = engine.warmup()
        print(f"warmup compile finished in {secs:.1f}s")

    try:
        import uvicorn  # noqa: F401

        from video_caption_tpu.env import assert_server_runtime_ready

        assert_server_runtime_ready()
        uvicorn.run("video_caption_tpu.server.app:app", host=args.host, port=args.port)
    except ImportError:
        print("fastapi/uvicorn unavailable; serving via stdlib HTTP server")
        from video_caption_tpu.server.stdlib_server import StdlibServer

        StdlibServer(args.host, args.port).serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
