"""Anonymous product telemetry (offline-safe).

Port of metavoice_tpu/telemetry.py, with the reference's API (fam/telemetry):
a ``TelemetryEvent`` dataclass, a persistent anonymous user id, the opt-out
``ANONYMIZED_TELEMETRY=False``, and no capture at all under pytest. The sink
is a local JSONL spool (``~/.cache/metavoice_tpu_torch/telemetry.jsonl``)
that an operator can forward; nothing is sent anywhere. Records have the JAX
package's keys (``distinct_id``, ``event``, ``properties``, ``timestamp``).
"""

from __future__ import annotations

import json
import os
import sys
import time
import uuid
from dataclasses import dataclass, field


@dataclass
class TelemetryEvent:
    name: str
    properties: dict = field(default_factory=dict)


class TelemetryClient:
    def __init__(self, spool_dir: str | None = None, enabled: bool | None = None):
        self._spool_dir = spool_dir or os.path.expanduser("~/.cache/metavoice_tpu_torch")
        if enabled is not None:  # explicit override (tests, embedding apps)
            self._enabled = enabled
        else:
            self._enabled = (
                os.environ.get("ANONYMIZED_TELEMETRY", "True").lower() != "false"
                and "pytest" not in sys.modules
            )

    @property
    def enabled(self) -> bool:
        return self._enabled

    def _user_id(self) -> str:
        """Persistent anonymous id (reference fam/telemetry/__init__.py:16-43)."""
        os.makedirs(self._spool_dir, exist_ok=True)
        path = os.path.join(self._spool_dir, "telemetry_user_id")
        if os.path.exists(path):
            with open(path) as f:
                return f.read().strip()
        uid = str(uuid.uuid4())
        with open(path, "w") as f:
            f.write(uid)
        return uid

    def capture(self, event: TelemetryEvent) -> None:
        if not self._enabled:
            return
        try:
            os.makedirs(self._spool_dir, exist_ok=True)
            record = {
                "distinct_id": self._user_id(),
                "event": event.name,
                "properties": event.properties,
                "timestamp": time.time(),
            }
            with open(os.path.join(self._spool_dir, "telemetry.jsonl"), "a") as f:
                f.write(json.dumps(record) + "\n")
        except Exception:
            pass  # telemetry must never break the product


def hash_dictionary(d: dict) -> str:
    """Stable job id from a property dict (reference fam/llm/utils.py
    hash_dictionary): md5 of the sorted-key JSON serialization."""
    import hashlib

    blob = json.dumps(d, sort_keys=True, default=str).encode("utf-8")
    return hashlib.md5(blob).hexdigest()


# module-level default client, the analogue of the reference's singleton
# ``posthog`` (fam/telemetry/posthog.py); importers may replace it
default_client = TelemetryClient()
