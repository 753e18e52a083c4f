"""Per-request trace ids for the serving tier.

A request carries one id end to end: accepted from the client's
``X-Request-Id`` header (or minted at the front end) and bound to the
handler's context, where admission (:class:`~.scheduler.GenRequest`)
picks it up. Propagation is a ``contextvars.ContextVar``: everything on
the synchronous call path reads it without a parameter, and the
scheduler's worker thread, which runs outside that context, carries
the id on the request object instead.
"""

from __future__ import annotations

import contextvars
import re
import uuid

REQUEST_ID_HEADER = "X-Request-Id"

_request_id: "contextvars.ContextVar[str]" = contextvars.ContextVar(
    "hvd_serving_request_id", default="")

_UNSAFE = re.compile(r"[^A-Za-z0-9._:\-]")
_MAX_LEN = 64


def new_request_id() -> str:
    return uuid.uuid4().hex[:12]


def sanitize(rid: str) -> str:
    """A usable id from a client-supplied header value: length-bounded,
    shell/json/label-safe charset; empty or all-unsafe input gets a
    fresh id (a client must not be able to blank out tracing)."""
    rid = _UNSAFE.sub("", (rid or "").strip()[:_MAX_LEN])
    return rid or new_request_id()


def set_request_id(rid: str):
    """Bind the id to the current context; returns the reset token."""
    return _request_id.set(rid)


def reset_request_id(token) -> None:
    _request_id.reset(token)


def current_request_id() -> str:
    """The id bound to this context ('' outside a traced request)."""
    return _request_id.get()
