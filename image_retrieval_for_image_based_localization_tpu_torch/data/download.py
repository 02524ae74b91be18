"""Dataset and model-zoo bootstrap: verify or fetch (the JAX package's
``data/download.py``, the port's own copy).

The reference downloads its test sets, gnd pickles and pretrained
checkpoints at first use (cirtorch's ``utils/download.py``). Here:

  * artifacts already on disk (mounted or preloaded) are verified and used;
  * missing artifacts are fetched by a download engine: resumable (HTTP
    Range), retried with backoff, checksum-verified, archives extracted
    with path-traversal guards, and installed by atomic rename, so a killed
    process never leaves half an artifact in place;
  * with no network the fetch fails fast with an error that lists what to
    place where; nothing synthetic is substituted (callers opt into
    ``data.test_datasets.make_synthetic_dataset``).

The manifests point at the reference's upstream hosts (cirtorch's
cmp.felk.cvut.cz data server and the Oxford VGG image archives); their
names, URLs and sha256 pins are the JAX package's, and one setting,
``IRTPU_OFFLINE=1``, skips every network attempt in both packages.
"""

from __future__ import annotations

import hashlib
import http.client
import os
import tarfile
import time
import urllib.error
import urllib.request
import zipfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

# ---------------------------------------------------------------------------
# Manifests
# ---------------------------------------------------------------------------

_CIRTORCH = "https://cmp.felk.cvut.cz/cnnimageretrieval/data"
_OXVGG = "https://www.robots.ox.ac.uk/~vgg/data"


@dataclass(frozen=True)
class Artifact:
    """One downloadable artifact.

    url: source; dest: path relative to data_root where the *final*
    artifact lives (a file, or the directory an archive extracts into);
    extract: if True the fetched file is an archive extracted into
    ``dest``; sha256: optional integrity pin (None = unknown upstream).
    """

    url: str
    dest: str
    extract: bool = False
    sha256: Optional[str] = None
    members_strip: int = 0  # leading path components to strip on extract
    # flatten: drop ALL directory components on extract (cirtorch's own
    # paris install does `mv paris/*/*.jpg jpg/`; member basenames are
    # globally unique in those tarballs)
    flatten: bool = False


@dataclass(frozen=True)
class DatasetManifest:
    name: str
    artifacts: Sequence[Artifact] = field(default_factory=tuple)
    # paths (relative to data_root) whose existence == "installed"
    required: Sequence[str] = field(default_factory=tuple)


TEST_MANIFESTS: Dict[str, DatasetManifest] = {
    "oxford5k": DatasetManifest(
        "oxford5k",
        artifacts=(
            Artifact(f"{_OXVGG}/oxbuildings/oxbuild_images.tgz",
                     "oxford5k/jpg", extract=True),
            Artifact(f"{_CIRTORCH}/test/oxford5k/gnd_oxford5k.pkl",
                     "oxford5k/gnd_oxford5k.pkl"),
        ),
        required=("oxford5k/gnd_oxford5k.pkl", "oxford5k/jpg"),
    ),
    "paris6k": DatasetManifest(
        "paris6k",
        artifacts=(
            # paris tarballs nest as paris/<landmark>/<name>.jpg but the
            # gnd imlist names are flat: flatten like cirtorch's installer
            Artifact(f"{_OXVGG}/parisbuildings/paris_1.tgz",
                     "paris6k/jpg", extract=True, flatten=True),
            Artifact(f"{_OXVGG}/parisbuildings/paris_2.tgz",
                     "paris6k/jpg", extract=True, flatten=True),
            Artifact(f"{_CIRTORCH}/test/paris6k/gnd_paris6k.pkl",
                     "paris6k/gnd_paris6k.pkl"),
        ),
        required=("paris6k/gnd_paris6k.pkl", "paris6k/jpg"),
    ),
    # revisited protocols reuse the base images; only the gnd differs
    "roxford5k": DatasetManifest(
        "roxford5k",
        artifacts=(
            Artifact(f"{_OXVGG}/oxbuildings/oxbuild_images.tgz",
                     "roxford5k/jpg", extract=True),
            Artifact(f"{_CIRTORCH}/test/roxford5k/gnd_roxford5k.pkl",
                     "roxford5k/gnd_roxford5k.pkl"),
        ),
        required=("roxford5k/gnd_roxford5k.pkl", "roxford5k/jpg"),
    ),
    "rparis6k": DatasetManifest(
        "rparis6k",
        artifacts=(
            Artifact(f"{_OXVGG}/parisbuildings/paris_1.tgz",
                     "rparis6k/jpg", extract=True, flatten=True),
            Artifact(f"{_OXVGG}/parisbuildings/paris_2.tgz",
                     "rparis6k/jpg", extract=True, flatten=True),
            Artifact(f"{_CIRTORCH}/test/rparis6k/gnd_rparis6k.pkl",
                     "rparis6k/gnd_rparis6k.pkl"),
        ),
        required=("rparis6k/gnd_rparis6k.pkl", "rparis6k/jpg"),
    ),
}

TRAIN_MANIFESTS: Dict[str, DatasetManifest] = {
    "retrieval-SfM-120k": DatasetManifest(
        "retrieval-SfM-120k",
        artifacts=(
            Artifact(
                f"{_CIRTORCH}/train/retrieval-SfM-120k/"
                "retrieval-SfM-120k.pkl",
                "train/retrieval-SfM-120k/retrieval-SfM-120k.pkl",
            ),
            Artifact(
                f"{_CIRTORCH}/train/retrieval-SfM-120k/ims.tar.gz",
                "train/retrieval-SfM-120k/ims", extract=True,
            ),
        ),
        required=(
            "train/retrieval-SfM-120k/retrieval-SfM-120k.pkl",
            "train/retrieval-SfM-120k/ims",
        ),
    ),
}

# Pretrained model zoo (cirtorch's published networks; models.zoo.load_pretrained
# loads one into this package's RetrievalNet).
ZOO_MANIFESTS: Dict[str, Artifact] = {
    name: Artifact(f"{_CIRTORCH}/networks/{name}.pth", f"networks/{name}.pth")
    for name in (
        "retrievalSfM120k-resnet101-gem",
        "retrievalSfM120k-vgg16-gem",
        "rSfM120k-tl-resnet50-gem-w",
        "rSfM120k-tl-resnet101-gem-w",
    )
}

# Backwards-compatible layout tables (kept: tests + callers use these)
TEST_DATASET_FILES: Dict[str, List[str]] = {
    name: list(m.required) for name, m in TEST_MANIFESTS.items()
}
TRAIN_DATASET_FILES: Dict[str, List[str]] = {
    name: list(m.required) for name, m in TRAIN_MANIFESTS.items()
}


def offline() -> bool:
    return os.environ.get("IRTPU_OFFLINE", "") not in ("", "0")


# ---------------------------------------------------------------------------
# Fetch engine
# ---------------------------------------------------------------------------


class DownloadError(RuntimeError):
    pass


def _sha256_of(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def fetch(
    url: str,
    dest: str,
    sha256: Optional[str] = None,
    retries: int = 3,
    timeout: float = 30.0,
    chunk_bytes: int = 1 << 20,
    progress: bool = True,
) -> str:
    """Download ``url`` to ``dest``: resumable, retried, atomic.

    The partial stream goes to ``dest + '.part'``; on a retry after an
    interrupted transfer an HTTP Range request resumes where it stopped
    (servers without Range support restart cleanly). Only after the full
    body (and optional sha256 check) does an atomic rename publish
    ``dest`` — a crashed download never leaves a plausible-looking file.
    """
    if os.path.exists(dest):
        if sha256 and _sha256_of(dest) != sha256:
            raise DownloadError(f"{dest} exists but fails its sha256 pin")
        return dest
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    part = dest + ".part"
    last_err: Optional[Exception] = None
    for attempt in range(retries):
        try:
            have = os.path.getsize(part) if os.path.exists(part) else 0
            req = urllib.request.Request(url)
            if have:
                req.add_header("Range", f"bytes={have}-")
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                if have and resp.status != 206:
                    have = 0  # server ignored Range: restart
                mode = "ab" if have else "wb"
                total = resp.headers.get("Content-Length")
                total = int(total) + have if total else None
                done = have
                with open(part, mode) as f:
                    while True:
                        block = resp.read(chunk_bytes)
                        if not block:
                            break
                        f.write(block)
                        done += len(block)
                        if progress and total:
                            print(
                                f"\r  {os.path.basename(dest)}: "
                                f"{done / 1e6:.1f}/{total / 1e6:.1f} MB",
                                end="", flush=True,
                            )
                if progress and total:
                    print()
            if total is not None and done < total:
                # http.client returns SHORT (no exception) when the server
                # closes mid-body on an amt-bounded read — without this
                # check a disconnect would atomically publish a truncated
                # file; raising re-enters the retry loop, which resumes
                # from the .part offset with a Range request
                raise OSError(
                    f"short body from {url}: {done}/{total} bytes"
                )
            if sha256:
                got = _sha256_of(part)
                if got != sha256:
                    os.remove(part)
                    raise DownloadError(
                        f"sha256 mismatch for {url}: got {got}, want {sha256}"
                    )
            os.replace(part, dest)  # atomic publish
            return dest
        except (
            urllib.error.URLError,
            http.client.HTTPException,  # IncompleteRead/BadStatusLine: the
            ConnectionError,            # mid-transfer failures resume covers
            TimeoutError,
            OSError,
        ) as e:
            last_err = e
            if attempt + 1 < retries:
                time.sleep(2.0 ** attempt)
    raise DownloadError(f"failed to fetch {url} after {retries} attempts: {last_err}")


def _safe_members(
    names: Sequence[str], strip: int, flatten: bool = False
) -> Dict[str, str]:
    """Map archive member -> relative output path; reject traversal."""
    out = {}
    for name in names:
        parts = [p for p in name.replace("\\", "/").split("/") if p not in ("", ".")]
        if any(p == ".." for p in parts) or (parts and parts[0].startswith("/")):
            raise DownloadError(f"archive member escapes extraction dir: {name}")
        parts = parts[-1:] if flatten else parts[strip:]
        if parts:
            out[name] = os.path.join(*parts)
    return out


def extract_archive(
    path: str, dest_dir: str, members_strip: int = 0, flatten: bool = False
) -> None:
    """Extract a .tar[.gz|.bz2]/.zip into ``dest_dir`` (atomic: extracts to
    a staging dir, then renames). Path-traversal members are rejected."""
    staging = dest_dir + ".extracting"
    if os.path.exists(staging):
        import shutil

        shutil.rmtree(staging)
    os.makedirs(staging)
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            mapping = _safe_members(zf.namelist(), members_strip, flatten)
            for member, rel in mapping.items():
                if member.endswith("/"):
                    continue
                tgt = os.path.join(staging, rel)
                os.makedirs(os.path.dirname(tgt) or staging, exist_ok=True)
                with zf.open(member) as src, open(tgt, "wb") as dst:
                    dst.write(src.read())
    else:
        with tarfile.open(path) as tf:
            mapping = _safe_members(tf.getnames(), members_strip, flatten)
            for member in tf.getmembers():
                if not member.isfile() or member.name not in mapping:
                    continue
                tgt = os.path.join(staging, mapping[member.name])
                os.makedirs(os.path.dirname(tgt) or staging, exist_ok=True)
                src = tf.extractfile(member)
                assert src is not None
                with open(tgt, "wb") as dst:
                    dst.write(src.read())
    if os.path.exists(dest_dir):
        # merging into an existing dir (e.g. paris_1 then paris_2)
        for root, _, files in os.walk(staging):
            for fn in files:
                s = os.path.join(root, fn)
                rel = os.path.relpath(s, staging)
                d = os.path.join(dest_dir, rel)
                os.makedirs(os.path.dirname(d), exist_ok=True)
                os.replace(s, d)
        import shutil

        shutil.rmtree(staging)
    else:
        os.replace(staging, dest_dir)


def _install(manifest: DatasetManifest, data_root: str) -> None:
    for art in manifest.artifacts:
        dest = os.path.join(data_root, art.dest)
        if os.path.exists(dest) and not art.extract:
            # verify-or-fetch means VERIFY: a pre-existing pinned file
            # must pass its hash, same contract fetch() enforces
            if art.sha256 and _sha256_of(dest) != art.sha256:
                raise DownloadError(
                    f"{dest} exists but fails its sha256 pin")
            continue
        if art.extract:
            archive = os.path.join(
                data_root, "_downloads", os.path.basename(art.url)
            )
            # the marker is keyed by (archive, dest): a second artifact
            # extracting the same archive into a DIFFERENT dataset dir
            # (paris_1.tgz into paris6k/ then rparis6k/) must still run,
            # and a second archive into the SAME dir (paris_1 + paris_2)
            # must too
            marker = (
                archive + "." + art.dest.replace(os.sep, "_").replace("/", "_")
                + ".installed"
            )
            if os.path.exists(dest) and os.path.exists(marker):
                continue
            fetch(art.url, archive, sha256=art.sha256)
            extract_archive(
                archive, dest,
                members_strip=art.members_strip, flatten=art.flatten,
            )
            with open(marker, "w") as f:
                f.write(art.url + "\n")
        else:
            fetch(art.url, dest, sha256=art.sha256)


# ---------------------------------------------------------------------------
# Public verify-or-fetch API (reference download_test/download_train shape)
# ---------------------------------------------------------------------------


def check_test_dataset(data_root: str, dataset: str) -> bool:
    """True iff all artifacts for ``dataset`` exist under ``data_root``."""
    return all(
        os.path.exists(os.path.join(data_root, rel))
        for rel in TEST_DATASET_FILES.get(dataset, [f"{dataset}/gnd_{dataset}.pkl"])
    )


def _missing_error(kind: str, name: str, data_root: str,
                   rels: Sequence[str], err: Optional[Exception]) -> Exception:
    why = (
        "IRTPU_OFFLINE is set" if offline()
        else f"the download failed ({err})" if err
        else "no manifest covers it"
    )
    return FileNotFoundError(
        f"{kind} '{name}' not found under {data_root} and {why}. "
        f"Place these artifacts:\n  "
        + "\n  ".join(os.path.join(data_root, r) for r in rels)
        + ("\n(or generate a synthetic stand-in with "
           "data.test_datasets.make_synthetic_dataset)." if kind == "Dataset"
           else "")
    )


def download_test(
    data_root: str,
    dataset: str,
    manifests: Optional[Dict[str, DatasetManifest]] = None,
) -> None:
    """Ensure a test dataset is present: verify, else fetch per manifest.

    ``manifests`` overrides the built-in URL table (tests point it at a
    local HTTP server; deployments can point it at a mirror).
    """
    if check_test_dataset(data_root, dataset):
        return
    table = manifests if manifests is not None else TEST_MANIFESTS
    m = table.get(dataset)
    err: Optional[Exception] = None
    if m is not None and not offline():
        try:
            _install(m, data_root)
            if all(os.path.exists(os.path.join(data_root, r)) for r in m.required):
                return
            err = DownloadError(
                "manifest installed but required paths still missing "
                f"(upstream layout changed?): {list(m.required)}"
            )
        except DownloadError as e:
            err = e
    rels = (list(m.required) if m is not None
            else TEST_DATASET_FILES.get(dataset, []))
    raise _missing_error("Dataset", dataset, data_root, rels, err)


def download_train(
    data_root: str,
    dataset: str = "retrieval-SfM-120k",
    manifests: Optional[Dict[str, DatasetManifest]] = None,
) -> None:
    """Ensure a training dataset is present: verify, else fetch."""
    table = manifests if manifests is not None else TRAIN_MANIFESTS
    m = table.get(dataset)
    rels = list(m.required) if m is not None else []
    if rels and all(os.path.exists(os.path.join(data_root, r)) for r in rels):
        return
    err: Optional[Exception] = None
    if m is not None and not offline():
        try:
            _install(m, data_root)
            if all(os.path.exists(os.path.join(data_root, r)) for r in m.required):
                return
            err = DownloadError("required paths missing after install")
        except DownloadError as e:
            err = e
    raise _missing_error("Training dataset", dataset, data_root, rels, err)


def download_network(
    data_root: str,
    name: str,
    manifests: Optional[Dict[str, Artifact]] = None,
) -> str:
    """Ensure a pretrained zoo checkpoint is present; return its path.

    The returned ``.pth`` is cirtorch's ``{'state_dict', 'meta'}``;
    ``models.zoo.load_pretrained`` builds the model from it.
    """
    table = manifests if manifests is not None else ZOO_MANIFESTS
    art = table.get(name)
    if art is None:
        raise KeyError(
            f"unknown network '{name}'; zoo: {sorted(table)}"
        )
    dest = os.path.join(data_root, art.dest)
    if offline():
        if os.path.exists(dest):
            return dest
        raise _missing_error("Network", name, data_root, [art.dest], None)
    try:
        # fetch() short-circuits on an existing file AFTER verifying any
        # sha256 pin — keep the verify-or-fetch contract in one place
        return fetch(art.url, dest, sha256=art.sha256)
    except DownloadError as e:
        raise _missing_error("Network", name, data_root, [art.dest], e)
