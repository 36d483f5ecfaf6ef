""".vif sidecar: volume info persisted as JSON.

The reference writes VolumeInfo as jsonpb (ref: weed/pb/volume_info.go:55-76,
message at volume_server.proto:376-380), so plain JSON with camelCase keys is
format-compatible: {"files": [...], "version": N, "replication": "xyz"}.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field


@dataclass
class RemoteFile:
    backend_type: str = ""
    backend_id: str = ""
    key: str = ""
    offset: int = 0
    file_size: int = 0
    modified_time: int = 0
    extension: str = ""


@dataclass
class VolumeInfo:
    files: list[RemoteFile] = field(default_factory=list)
    version: int = 0
    replication: str = ""
    # RS geometry of the EC shards (0 = the default 10.4); our extension —
    # the reference fixes the geometry at compile time (ec_encoder.go:17-23)
    data_shards: int = 0
    parity_shards: int = 0


def load_volume_info(path: str) -> VolumeInfo | None:
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    info = VolumeInfo(
        version=int(d.get("version", 0)),
        replication=d.get("replication", ""),
        data_shards=int(d.get("dataShards", 0)),
        parity_shards=int(d.get("parityShards", 0)),
    )
    for fd in d.get("files", []) or []:
        info.files.append(
            RemoteFile(
                backend_type=fd.get("backendType", ""),
                backend_id=fd.get("backendId", ""),
                key=fd.get("key", ""),
                offset=int(fd.get("offset", 0)),
                file_size=int(fd.get("fileSize", 0)),
                modified_time=int(fd.get("modifiedTime", 0)),
                extension=fd.get("extension", ""),
            )
        )
    return info


def save_volume_info(path: str, info: VolumeInfo) -> None:
    d = {
        "files": [
            {
                "backendType": f.backend_type,
                "backendId": f.backend_id,
                "key": f.key,
                "offset": f.offset,
                "fileSize": f.file_size,
                "modifiedTime": f.modified_time,
                "extension": f.extension,
            }
            for f in info.files
        ],
        "version": info.version,
        "replication": info.replication,
    }
    if info.data_shards:
        d["dataShards"] = info.data_shards
        d["parityShards"] = info.parity_shards
    with open(path, "w") as f:
        json.dump(d, f, indent=2)
