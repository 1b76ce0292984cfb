"""GCS helpers: a copy of ``certifiedgpt_tpu/utils/gcs.py`` for the port.

The reference mounts its output bucket with gcsfuse
(ref ``utils/gcsfuse.py:4-9``, remounted on demand by
``common/metrics.py:37-38``). Kept for operational parity; checkpoint
paths may also point straight at fuse-mounted directories since the npz
writer uses atomic rename within the target directory.
"""

from __future__ import annotations

import os
import subprocess

from certifiedgpt_tpu_torch.common.logging import get_logger


def mount_gcsfuse(
    bucket_name: str = "certifiedgpt_storage", mount_point: str = "~/storage"
) -> bool:
    logger = get_logger()
    mount_point = os.path.expanduser(mount_point)
    os.makedirs(mount_point, exist_ok=True)
    try:
        subprocess.run(["gcsfuse", bucket_name, mount_point], check=True)
        logger.info("Mounted gs://%s at %s", bucket_name, mount_point)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError) as exc:
        logger.warning("gcsfuse mount failed: %s", exc)
        return False


def ensure_mounted(
    path: str,
    bucket_name: str = "certifiedgpt_storage",
    mount_point: str = "~/storage",
) -> None:
    """Remount the bucket at its MOUNT POINT when an expected output path
    is missing (ref ``metrics.py:37-38``). ``path`` is the missing output
    location (often a subdirectory of the mount) — mounting the bucket at
    ``path`` itself would graft the bucket ROOT onto a run directory."""
    if not os.path.exists(os.path.expanduser(path)):
        mount_gcsfuse(bucket_name, mount_point)
