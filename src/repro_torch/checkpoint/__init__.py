"""Checkpointing of the dist chief: npz archives behind an atomic, checksummed
MANIFEST.json, written off the caller's thread — the reference's format
(`repro.checkpoint`), so snapshots cross between the packages."""
from repro_torch.checkpoint.npz import (  # noqa: F401
    CorruptCheckpointError,
    file_sha256,
    latest_step,
    manifest_entries,
    read_manifest,
    step_path,
    verify_entry,
)
from repro_torch.checkpoint.state import dist_restore, dist_snapshot  # noqa: F401
from repro_torch.checkpoint.writer import AsyncCheckpointer  # noqa: F401
