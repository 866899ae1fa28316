"""Archive extraction (reference core/util/ArchiveUtils.java — unzip /
untar / gunzip into a destination directory), with path-traversal
protection the reference lacked.

The port's own copy of the JAX package's `utils/archive.py`.
"""

from __future__ import annotations

import gzip
import os
import shutil
import tarfile
import zipfile


def _check_within(dest: str, target: str) -> None:
    dest_abs = os.path.abspath(dest)
    target_abs = os.path.abspath(target)
    if not (target_abs + os.sep).startswith(dest_abs + os.sep) \
            and target_abs != dest_abs:
        raise ValueError(f"Archive member escapes destination: {target}")


def unzip_file_to(file: str, dest: str) -> None:
    os.makedirs(dest, exist_ok=True)
    if file.endswith(".zip"):
        with zipfile.ZipFile(file) as z:
            for name in z.namelist():
                _check_within(dest, os.path.join(dest, name))
            z.extractall(dest)
    elif file.endswith((".tar", ".tar.gz", ".tgz")):
        mode = "r" if file.endswith(".tar") else "r:gz"
        with tarfile.open(file, mode) as t:
            for member in t.getmembers():
                _check_within(dest, os.path.join(dest, member.name))
            # filter="data" additionally rejects symlink escapes (a symlink
            # member pointing outside dest + a member written through it
            # would pass the name check alone), absolute names and device
            # files.
            t.extractall(dest, filter="data")
    elif file.endswith(".gz"):
        out = os.path.join(dest, os.path.basename(file)[:-3])
        with gzip.open(file, "rb") as src, open(out, "wb") as dst:
            shutil.copyfileobj(src, dst)
    else:
        raise ValueError(f"Unknown archive format: {file}")
