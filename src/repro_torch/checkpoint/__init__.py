"""Checkpointing (port of `repro.checkpoint`): npz archives behind an atomic,
checksummed MANIFEST.json, written off the caller's thread — the reference's
format, so snapshots cross between the packages. Full-state mesh snapshots
(params, the whole GuidedState and the data cursor) with resume, serving's
warm start from their params, the v1 `save` / `restore`, and the dist
chief's snapshots. Restoring onto another mesh (`train_state_shardings`)
waits for sharding."""
from repro_torch.checkpoint.npz import (  # noqa: F401
    CorruptCheckpointError,
    file_sha256,
    latest_step,
    manifest_entries,
    read_manifest,
    restore,
    restore_latest,
    save,
    step_path,
    verify_entry,
)
from repro_torch.checkpoint.state import (  # noqa: F401
    dist_restore,
    dist_snapshot,
    model_config_from_manifest,
    restore_subtree,
    restore_train_state,
    snapshot,
    spec_meta,
)
from repro_torch.checkpoint.writer import (  # noqa: F401
    AsyncCheckpointer,
    manifest_meta,
    save_train_state,
)
