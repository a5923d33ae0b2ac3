"""GCS Pub/Sub ingest adapter (BlackGEM night-mode event transport).

The reference's Google driver feeds its queue from a Pub/Sub streaming
subscription on the raw-bucket's object-finalise events
(/root/reference/blackbox_slurm_google.py:40-43, 219-256).  Same shape
here: a subscriber thread pushes gs:// paths into the scheduler's
queue.  Import-gated (google-cloud-pubsub is not in this image); the
message-parsing logic is a pure function so it tests without the
dependency.
"""

from __future__ import annotations

import json
import logging
import queue
from typing import Optional

log = logging.getLogger(__name__)


def parse_bucket_event(message_data: bytes,
                       attributes: Optional[dict] = None,
                       suffix: str = ".fits.fz") -> Optional[str]:
    """GCS object-finalise notification -> gs:// path (or None).

    Accepts both the JSON payload schema and the attribute-only form
    the reference consumes (objectId/bucketId attributes).
    """
    attributes = attributes or {}
    bucket = attributes.get("bucketId")
    name = attributes.get("objectId")
    event = attributes.get("eventType", "OBJECT_FINALIZE")
    if not (bucket and name):
        try:
            payload = json.loads(message_data.decode() or "{}")
        except (UnicodeDecodeError, json.JSONDecodeError):
            return None
        bucket = payload.get("bucket", bucket)
        name = payload.get("name", name)
    if event != "OBJECT_FINALIZE" or not (bucket and name):
        return None
    if suffix and not name.endswith(suffix):
        return None
    return f"gs://{bucket}/{name}"


class PubSubIngest:
    """Streaming subscription feeding a queue with raw-frame paths."""

    def __init__(self, project: str, subscription: str,
                 q: "queue.Queue[str]", suffix: str = ".fits.fz"):
        try:
            from google.cloud import pubsub_v1  # type: ignore
        except ImportError as e:            # pragma: no cover - env-gated
            raise RuntimeError(
                "Pub/Sub ingest needs google-cloud-pubsub; not available "
                "in this environment") from e
        self._client = pubsub_v1.SubscriberClient()   # pragma: no cover
        self._path = self._client.subscription_path(  # pragma: no cover
            project, subscription)
        self.q = q
        self.suffix = suffix
        self._future = None

    def _callback(self, message):           # pragma: no cover - env-gated
        path = parse_bucket_event(message.data, dict(message.attributes),
                                  self.suffix)
        if path is not None:
            self.q.put(path)
        message.ack()

    def start(self):                        # pragma: no cover - env-gated
        self._future = self._client.subscribe(self._path, self._callback)
        log.info("pubsub ingest started on %s", self._path)
        return self

    def stop(self):                         # pragma: no cover - env-gated
        if self._future is not None:
            self._future.cancel()
