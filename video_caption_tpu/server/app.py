"""FastAPI app assembly (reference: server/app.py:10-27): routers mounted at
both "/" (compat) and the versioned prefix "/api/v1"; permissive CORS."""
from __future__ import annotations

from fastapi import FastAPI
from fastapi.middleware.cors import CORSMiddleware

from video_caption_tpu.server.routes import health, inference
from video_caption_tpu.server.settings import SETTINGS


def create_app() -> FastAPI:
    app = FastAPI(title="Video Caption Backend", version="2.0.0")
    app.add_middleware(
        CORSMiddleware,
        allow_origins=list(SETTINGS.allow_origins),
        allow_credentials=True,
        allow_methods=["*"],
        allow_headers=["*"],
    )
    for router in (health.router, inference.router):
        app.include_router(router)                              # compat mount
        app.include_router(router, prefix=SETTINGS.api_prefix)  # versioned mount
    return app


app = create_app()
