"""Download/unpack helpers (reference ``bert4rec/datasets/dataset_utils.py``).

urllib-based equivalents of the reference's wget flow: ``download`` with a
progress callback (dataset_utils.py:54-76), ``unzip``/``untar`` (:79-104),
``download_and_unpack_to_folder`` temp-dir flow (:107-138) and
``check_availability_via_download_size`` +-2%% byte-size check (:37-51).

Port of ``bert4rec_tpu/datasets/dataset_utils.py``.
"""

import pathlib
import shutil
import tarfile
import tempfile
import urllib.request
import zipfile
from typing import Optional


def get_byte_size(path: pathlib.Path) -> int:
    """Total byte size of a file or (recursively) a directory."""
    path = pathlib.Path(path)
    if path.is_file():
        return path.stat().st_size
    if path.is_dir():
        return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())
    return -1


def check_availability_via_download_size(path: pathlib.Path,
                                         expected_size: int,
                                         tolerance: float = 0.02) -> bool:
    """True iff ``path`` exists and its size is within +-tolerance of expected."""
    actual = get_byte_size(path)
    if actual < 0:
        return False
    return abs(actual - expected_size) <= tolerance * expected_size


def download(url: str, dest: pathlib.Path, progress: bool = True) -> pathlib.Path:
    """Download ``url`` to file ``dest`` (parent dirs created)."""
    dest = pathlib.Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)

    def _report(block_num, block_size, total_size):  # pragma: no cover
        if not progress or total_size <= 0:
            return
        done = min(block_num * block_size, total_size)
        pct = 100.0 * done / total_size
        print(f"\rDownloading {url}: {pct:5.1f}%", end="", flush=True)

    urllib.request.urlretrieve(url, dest, reporthook=_report)
    if progress:
        print()
    return dest


def unzip(zip_path: pathlib.Path, dest_dir: pathlib.Path) -> pathlib.Path:
    dest_dir = pathlib.Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(zip_path, "r") as zf:
        zf.extractall(dest_dir)
    return dest_dir


def untar(tar_path: pathlib.Path, dest_dir: pathlib.Path) -> pathlib.Path:
    dest_dir = pathlib.Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    with tarfile.open(tar_path, "r:*") as tf:
        tf.extractall(dest_dir)
    return dest_dir


def download_and_unpack_to_folder(url: str,
                                  dest_dir: pathlib.Path,
                                  archive_type: str = "zip",
                                  strip_top_level: bool = False,
                                  progress: bool = True) -> pathlib.Path:
    """Download an archive to a temp dir, unpack it into ``dest_dir``.

    With ``strip_top_level`` the single top-level folder inside the archive is
    flattened away (the MovieLens zips wrap everything in ``ml-1m/`` etc.).
    """
    dest_dir = pathlib.Path(dest_dir)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        archive = tmp / "archive"
        download(url, archive, progress=progress)
        extract_dir = tmp / "extracted"
        if archive_type == "zip":
            unzip(archive, extract_dir)
        elif archive_type in ("tar", "tar.gz", "tgz"):
            untar(archive, extract_dir)
        else:
            raise ValueError(f"Unknown archive type: {archive_type}")

        src: Optional[pathlib.Path] = extract_dir
        if strip_top_level:
            entries = list(extract_dir.iterdir())
            if len(entries) == 1 and entries[0].is_dir():
                src = entries[0]
        dest_dir.mkdir(parents=True, exist_ok=True)
        for item in src.iterdir():
            target = dest_dir / item.name
            if target.exists():
                if target.is_dir():
                    shutil.rmtree(target)
                else:
                    target.unlink()
            shutil.move(str(item), str(target))
    return dest_dir


def join_movies(ratings, movies):
    """Inner-join movie metadata onto ratings by ``sid`` via dict maps.

    Same result as ``pd.merge(ratings, movies)`` for unique movie ``sid``s
    (membership-based inner join, so NaN metadata values survive like they
    do under merge), but hash-map column lookups instead of full merge
    machinery — several times faster at ML-20M scale (20M rows). Falls
    back to ``pd.merge`` if ``sid`` is not unique (merge's row-per-match
    semantics cannot be expressed as a map).
    """
    import pandas as pd

    if not movies["sid"].is_unique:
        return pd.merge(ratings, movies)
    m = movies.set_index("sid")
    matched = ratings["sid"].isin(m.index)
    out = (ratings if bool(matched.all())
           else ratings[matched].reset_index(drop=True))
    out = out.copy(deep=False)
    for col in movies.columns:
        if col != "sid":
            out[col] = out["sid"].map(m[col])
    return out
