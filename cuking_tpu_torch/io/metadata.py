"""Port of ``cuking_tpu/io/metadata.py`` (a copy).

The ``metadata.json`` contract (cuking.cu:475-501; mt_to_cuking_inputs.py:40-47).

``<input>/metadata.json`` = ``{"num_sites": int, "samples": [id, ...]}`` where
the list position IS the ``col_idx`` (the producer sorts by col_idx before
writing).  It must be read before anything else; sample IDs in results are
resolved through this ordering (cuking.cu:488-494, 811-824)."""

from __future__ import annotations

import json
from dataclasses import dataclass

from cuking_tpu_torch.io.uri import Storage
from cuking_tpu_torch.utils.status import FailedPreconditionError


@dataclass(frozen=True)
class InputMetadata:
    num_sites: int
    samples: list[str]

    @property
    def num_samples(self) -> int:
        return len(self.samples)


def read_metadata(storage: Storage, input_uri: str) -> InputMetadata:
    uri = storage.join(input_uri, "metadata.json")
    try:
        raw = storage.read_bytes(uri)
    except OSError as e:
        raise FailedPreconditionError(f"Failed to read metadata: {e}")
    try:
        obj = json.loads(raw)
    except json.JSONDecodeError:
        raise FailedPreconditionError("Failed to parse metadata JSON")
    if "num_sites" not in obj or "samples" not in obj:
        raise FailedPreconditionError(
            "Metadata JSON must contain num_sites and samples"
        )
    return InputMetadata(
        num_sites=int(obj["num_sites"]), samples=[str(s) for s in obj["samples"]]
    )


def write_metadata(storage: Storage, input_uri: str, metadata: InputMetadata) -> None:
    uri = storage.join(input_uri, "metadata.json")
    with storage.open_write(uri) as f:
        f.write(
            json.dumps(
                {"num_sites": metadata.num_sites, "samples": metadata.samples}
            ).encode()
        )
