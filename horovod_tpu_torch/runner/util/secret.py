"""Shared-secret generation for launcher control-plane authentication.

Reference horovod/runner/common/util/secret.py:26-34: every network
service message is HMAC-signed with a per-job secret the launcher
generates and passes to workers via env. The env name is the JAX
package's, so one launch script serves either package.
"""

import base64
import os

ENV_SECRET = "HVD_TPU_SECRET_KEY"


def make_secret_key() -> bytes:
    return base64.b64encode(os.urandom(32))


def secret_from_env() -> bytes:
    v = os.environ.get(ENV_SECRET, "")
    if not v:
        raise RuntimeError(f"{ENV_SECRET} not set; launcher must provide it")
    return v.encode() if isinstance(v, str) else v
