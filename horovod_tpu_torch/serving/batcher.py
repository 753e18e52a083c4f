"""Admission errors of the serving tier.

The dynamic batcher itself belongs to the one-shot ``predict`` path,
which this package does not serve yet; the decode scheduler raises
these three, with the same meaning (and HTTP mapping) as in the JAX
package.
"""


class QueueFull(RuntimeError):
    """Admission queue at capacity — shed load now, retry later (429)."""


class Draining(RuntimeError):
    """The server is draining for shutdown; no new admissions (503)."""


class RequestTimeout(TimeoutError):
    """The request's deadline expired before results arrived (504)."""
