"""repro_torch.profile — persistence and reduction of XFA profiles.

  snapshot.py   schema-versioned columnar serialization of a FoldedTable
                (the same byte layout as the reference package)
  store.py      run dir of per-process snapshot rings + the reducer
  index.py      run manifests (register_run)

Shards written here load in the reference CLI (`python -m repro.profile`).
"""

from .snapshot import SCHEMA_VERSION, SNAPSHOT_SUFFIX, ProfileSnapshot
from .store import (ProfileStore, RetentionPolicy, load_profile,
                    set_host_label, tracer_folded)
from .index import kv_pair, register_run

__all__ = [
    "SCHEMA_VERSION", "SNAPSHOT_SUFFIX", "ProfileSnapshot",
    "ProfileStore", "RetentionPolicy", "load_profile", "set_host_label",
    "tracer_folded", "kv_pair", "register_run",
]
