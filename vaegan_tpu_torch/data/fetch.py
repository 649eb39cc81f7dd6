"""Dataset acquisition: the reference's hand X-ray zip -> a ready ``nii/`` dir.

A copy of ``vaegan_tpu/data/fetch.py`` (pure ``urllib`` / ``zipfile``; the port
keeps its own so that it imports nothing of the JAX package).

The reference's first executable step downloads ``ImagesHands.zip`` from a Google
Drive link and unzips it in place (README.md:43-45, commented shell cells):

    file_download_link = "https://docs.google.com/uc?export=download&id=1lsCy..."
    # !wget -O ImagesHands.zip --no-check-certificate "$file_download_link"
    # !unzip -o ImagesHands.zip

``fetch_dataset`` is the framework equivalent: download (any http(s)/file URL —
Drive links need no special casing for files this size), extract every ``.nii`` /
``.nii.gz`` member into a flat directory (the layout ``NiftiDataset`` expects),
and report what was ingested. See docs/DATA.md for the full ingest story.
"""

from __future__ import annotations

import shutil
import tempfile
import urllib.request
import zipfile
from pathlib import Path
from typing import Optional

#: the reference's published download link (README.md:43). Subject to the usual
#: Drive-link caveats (quota, confirmation interstitials for large files); any
#: mirror of ImagesHands.zip works the same.
REFERENCE_DATASET_URL = (
    "https://docs.google.com/uc?export=download&id=1lsCyvsaZ2GMxkY5QL5HFz-I40ihmtE1K"
)


def fetch_dataset(url: str = REFERENCE_DATASET_URL, dest: str = "nii",
                  timeout: float = 120.0, archive_path: Optional[str] = None) -> int:
    """Download (or reuse) the dataset zip and extract NIfTI files into ``dest``.

    - ``url``: zip location; http(s) or file://. Ignored when ``archive_path``
      points at an already-downloaded zip (the offline path).
    - ``dest``: flat output directory; nested zip members are flattened to their
      basenames, matching ``NiftyDataset(root_dir)``'s flat-dir listing
      (reference README.md:58-60).
    Returns the number of NIfTI files extracted. Raises URLError/HTTPError on
    network failure (no retry wrapping — surface the real error) and ValueError
    if the archive holds no NIfTI members.
    """
    dest_dir = Path(dest)
    dest_dir.mkdir(parents=True, exist_ok=True)

    if archive_path is not None:
        archive_file = open(archive_path, "rb")
    else:
        # stream the download to an unnamed temp file (zipfile needs a seekable
        # object; buffering a multi-GB archive wholly in RAM does not scale.
        # A real file, not SpooledTemporaryFile: the spooled wrapper lacks
        # seekable()/readable() before Python 3.11, which zipfile probes)
        archive_file = tempfile.TemporaryFile()
        with urllib.request.urlopen(url, timeout=timeout) as r:
            shutil.copyfileobj(r, archive_file)
        archive_file.seek(0)

    n = 0
    seen: dict = {}
    with archive_file, zipfile.ZipFile(archive_file) as zf:
        for member in zf.infolist():
            name = Path(member.filename).name
            if member.is_dir() or not name.endswith((".nii", ".nii.gz")):
                continue
            if name in seen:  # flattening must not silently drop data
                raise ValueError(
                    f"archive has duplicate basenames ({seen[name]!r} and "
                    f"{member.filename!r} both flatten to {name!r}); extract "
                    f"it manually and pass the flat directory via --data-dir")
            seen[name] = member.filename
            with zf.open(member) as src, open(dest_dir / name, "wb") as out:
                shutil.copyfileobj(src, out)
            n += 1
    if n == 0:
        raise ValueError(
            f"archive from {archive_path or url} contains no .nii/.nii.gz members")
    return n
