"""Dataset acquisition and curation, the port's copy.

A copy of `cough_detector_tpu/data/acquire.py`, on the port's own
`audio_io` and `synth`, kept here because the port imports nothing of the
JAX package. ESC-50's metadata is read with the csv module; the COUGHVID
selection takes a pandas frame and imports pandas only when it runs.
Capability ports of the reference's ingest scripts with identical
selection semantics:

  * ESC-50 download + extraction (reference: src/dataset.py:333-365)
  * ESC-50 → cough/non_cough reorganization with hard negatives
    (reference: prepare_data.py:83-94, setup_data.py:49-81)
  * synthetic sample generation (reference: setup_data.py:95-164) via the
    deterministic generators in data.synth
  * COUGHVID download, confidence filtering, capping, and conversion
    (reference: setup_coughvid.py:43-289) — per-clip failures are
    quarantined WITH COUNTS, never silently swallowed (the reference
    swallows them, setup_coughvid.py:261-262).
"""

from __future__ import annotations

import shutil
import urllib.request
import zipfile
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from . import audio_io, synth
from .datasets import read_esc50_meta

ESC50_URL = "https://github.com/karoldvl/ESC-50/archive/master.zip"
COUGHVID_URL = (
    "https://zenodo.org/record/4048312/files/public_dataset.zip?download=1"
)

COUGH_CLASS = 24
# The reference uses three different ESC-50 hard-negative selections, one
# per ingest pipeline — training-data composition is the thing its
# postmortem says mattered most, so each list is reproduced exactly:
# setup_data.py:63 — 7 curated confusables (breathing, snoring, sneezing,
# crying, clapping, laughing, door knock).
HARD_NEGATIVES = [20, 21, 22, 23, 25, 26, 38]
# prepare_data.py:84-94 — the 7 plus mouse_click(39) and vacuum_cleaner(36).
PREPARE_DATA_NEGATIVES = [20, 21, 22, 23, 25, 26, 38, 39, 36]
# setup_coughvid.py:322-340 — 17 classes for the COUGHVID+ESC-50 merge
# (adds brushing_teeth, drinking, knocks, clicks, typing, can_opening,
# clock_alarm, dog, washing_machine, vacuum).
COUGHVID_MERGE_NEGATIVES = [
    20, 21, 22, 23, 25, 26, 27, 28, 29, 30, 31, 32, 34, 38, 0, 35, 36,
]


def _esc50_complete(esc50_dir: Path) -> bool:
    """Cheap structural check that an ESC-50 tree is fully extracted:
    the metadata CSV plus the full 2,000-clip audio directory."""
    audio = esc50_dir / "audio"
    return (
        (esc50_dir / "meta" / "esc50.csv").exists()
        and audio.is_dir()
        and sum(1 for _ in audio.glob("*.wav")) >= 2000
    )


def download_esc50(target_dir: str) -> str:
    """Download + extract ESC-50 (idempotent)
    (reference: src/dataset.py:333-365).

    An existing directory counts as downloaded only if it passes the
    completeness check — an interrupted extraction (Ctrl-C / disk full)
    must not be silently accepted as the corpus on the next run."""
    target = Path(target_dir)
    target.mkdir(parents=True, exist_ok=True)
    esc50_dir = target / "ESC-50-master"
    if esc50_dir.exists():
        if _esc50_complete(esc50_dir):
            print("ESC-50 already downloaded")
            return str(esc50_dir)
        print(
            f"ESC-50 at {esc50_dir} is incomplete (interrupted extraction?) "
            "— re-downloading"
        )
    zip_path = target / "esc50.zip"
    print("Downloading ESC-50 dataset...")
    urllib.request.urlretrieve(ESC50_URL, zip_path)
    print("Extracting...")
    with zipfile.ZipFile(zip_path, "r") as z:
        z.extractall(target)
    zip_path.unlink()
    if not _esc50_complete(esc50_dir):
        raise RuntimeError(f"ESC-50 extraction incomplete at {esc50_dir}")
    print(f"ESC-50 downloaded to {esc50_dir}")
    return str(esc50_dir)


def reorganize_esc50(
    esc50_dir: str,
    output_dir: str,
    negatives: Optional[list] = None,
    prefix: str = "esc50_",
) -> Tuple[int, int]:
    """Copy ESC-50 coughs → cough/, hard negatives → non_cough/
    (reference: setup_data.py:49-81)."""
    esc50 = Path(esc50_dir)
    out = Path(output_dir)
    cough_dir = out / "cough"
    non_cough_dir = out / "non_cough"
    cough_dir.mkdir(parents=True, exist_ok=True)
    non_cough_dir.mkdir(parents=True, exist_ok=True)

    negatives = negatives if negatives is not None else HARD_NEGATIVES
    audio_dir = esc50 / "audio"
    n_cough = n_neg = 0
    for row in read_esc50_meta(esc50):
        src = audio_dir / row["filename"]
        if not src.exists():
            continue
        if int(row["target"]) == COUGH_CLASS:
            shutil.copy2(src, cough_dir / f"{prefix}{row['filename']}")
            n_cough += 1
        elif int(row["target"]) in negatives:
            shutil.copy2(src, non_cough_dir / f"{prefix}{row['filename']}")
            n_neg += 1
    return n_cough, n_neg


def generate_synthetic_dataset(
    output_dir: str,
    n_coughs: int = 50,
    n_non_coughs: int = 100,
    sample_rate: int = 16000,
    seed: int = 0,
    hard_negative_frac: float = 0.0,
    hard_negative_weights=None,
) -> Tuple[int, int]:
    """Deterministic synthetic coughs + non-coughs
    (reference: setup_data.py:95-164).

    `hard_negative_frac` converts that fraction of the negative class
    from stationary noise into cough-confusable hard negatives (voiced
    speech / laughs / throat clears, `synth.synthetic_hard_negative`) —
    the data-curation step the reference plans in
    IMPROVEMENT_PLAN.md:81-85,142-144. 0.0 reproduces the reference's
    setup_data.py menu exactly; the r4 BASELINE matrix measures ~0.3
    closing the confusables FP gap the behavioral protocol exposes.
    `hard_negative_weights` ({kind: weight}) skews the hard-negative
    kind mix (synth.synthetic_hard_negative) — laugh-heavy curation
    when laughs are the measured FP residue.
    Determinism contract: file i's contents depend only on (seed, i,
    the weights, and whether i falls in the hard tail), never on the
    other files."""
    if not 0.0 <= hard_negative_frac <= 1.0:
        raise ValueError(
            f"hard_negative_frac must be a fraction in [0, 1], got "
            f"{hard_negative_frac!r} (did you pass a percentage?)"
        )
    out = Path(output_dir)
    cough_dir = out / "cough"
    non_cough_dir = out / "non_cough"
    cough_dir.mkdir(parents=True, exist_ok=True)
    non_cough_dir.mkdir(parents=True, exist_ok=True)

    for i in range(n_coughs):
        wave = synth.synthetic_cough(seed + i, 2.0, sample_rate)
        audio_io.write_wav(
            cough_dir / f"synthetic_cough_{i:03d}.wav", wave, sample_rate
        )
    n_hard = int(round(n_non_coughs * hard_negative_frac))
    for i in range(n_non_coughs):
        if i < n_non_coughs - n_hard:
            wave = synth.synthetic_non_cough(seed + 1000 + i, 2.0,
                                             sample_rate)
            name = f"synthetic_other_{i:03d}.wav"
        else:
            wave = synth.synthetic_hard_negative(
                seed + 1000 + i, 2.0, sample_rate,
                kind_weights=hard_negative_weights,
            )
            name = f"synthetic_hard_{i:03d}.wav"
        audio_io.write_wav(non_cough_dir / name, wave, sample_rate)
    return n_coughs, n_non_coughs


def download_coughvid(target_dir: str) -> Optional[str]:
    """Download + extract COUGHVID from Zenodo (~950 MB), idempotent
    (reference: setup_coughvid.py:43-92). Returns the extracted dir or None
    on failure (caller decides fallback)."""
    target = Path(target_dir)
    target.mkdir(parents=True, exist_ok=True)
    sentinel = target / ".cdt_extract_complete"

    def _coughvid_complete(d: Path) -> bool:
        # Fully extracted = the compiled-metadata CSV is present (the file
        # selection reads it: prepare_coughvid below; reference
        # setup_coughvid.py:118-127) — an interrupted extractall that died
        # before the CSV must not count as downloaded.
        return sentinel.exists() or any(d.glob("**/metadata_compiled.csv"))

    for candidate in ("public_dataset", "coughvid"):
        cdir = target / candidate
        if cdir.exists():
            if _coughvid_complete(cdir):
                print("COUGHVID already downloaded")
                return str(cdir)
            print(
                f"COUGHVID at {cdir} looks incomplete (interrupted "
                "extraction?) — re-downloading"
            )
            break
    zip_path = target / "coughvid.zip"
    try:
        print("Downloading COUGHVID (~950 MB)...")
        urllib.request.urlretrieve(COUGHVID_URL, zip_path)
        print("Extracting...")
        with zipfile.ZipFile(zip_path, "r") as z:
            z.extractall(target)
        zip_path.unlink()
        sentinel.touch()
    except Exception as e:
        print(f"COUGHVID download failed: {e}")
        return None
    for candidate in ("public_dataset", "coughvid"):
        if (target / candidate).exists():
            return str(target / candidate)
    return str(target)


def select_coughvid(
    meta,
    max_coughs: int = 3000,
    cough_threshold: float = 0.8,
    non_cough_threshold: float = 0.2,
    seed: int = 42,
    fallback_uuids=None,
):
    """Reference-exact COUGHVID selection over a metadata frame; returns
    (coughs, non_coughs) row subsets (reference: setup_coughvid.py:155-235).

    Rules, in reference order:
      * cough_detected > 0.8 → cough; < 0.2 → non-cough (rows with a NaN
        confidence score 0.0 and take neither confidence branch —
        setup_coughvid.py:180-189);
      * status CONTAINING "healthy" (substring of the lowercased field,
        so "healthy_*" variants count — setup_coughvid.py:193-195) with
        confidence < 0.5 → non-cough;
      * fallback when high-confidence coughs < 100 ALONE
        (setup_coughvid.py:207): shuffle everything, 80 % → cough,
        20 % → non-cough. The reference's fallback pool is ALL audio
        files on disk — including files with no metadata row
        (setup_coughvid.py:209-210 shuffles `audio_files`, not df rows) —
        so callers with a file listing pass it as `fallback_uuids`
        (uuid stems); the fallback then splits that full pool, returned
        as uuid-only row frames. Without it, the metadata rows are the
        pool (the best available approximation);
      * coughs ranked by confidence, capped at max_coughs
        (setup_coughvid.py:222-227);
      * non-coughs SHUFFLE-then-capped at 1.5× coughs
        (setup_coughvid.py:233-235) — a random subset, not a
        metadata-order prefix.
    The reference shuffles with the unseeded global RNG; here both
    shuffles draw from `seed` so ingests are reproducible (divergence
    documented in docs/PARITY.md).
    """
    if "cough_detected" not in meta.columns:
        raise ValueError("COUGHVID metadata missing cough_detected column")
    rng = np.random.default_rng(seed)
    conf = meta["cough_detected"]
    conf_val = conf.fillna(0.0)
    has_conf = conf.notna()

    is_cough = has_conf & (conf_val > cough_threshold)
    is_non = has_conf & (conf_val < non_cough_threshold)
    if "status" in meta.columns:
        status = meta["status"].fillna("").astype(str).str.lower()
        is_non |= status.str.contains("healthy") & (conf_val < 0.5)
    coughs = meta[is_cough]
    non_coughs = meta[is_non & ~is_cough]

    fallback = len(coughs) < 100
    if fallback:
        import pandas as pd

        pool = (
            pd.DataFrame({"uuid": [str(u) for u in fallback_uuids]})
            if fallback_uuids is not None
            else meta
        )
        order = rng.permutation(len(pool))
        cut = int(len(pool) * 0.8)
        coughs = pool.iloc[order[:cut]]
        non_coughs = pool.iloc[order[cut:]]

    if fallback:
        # Fallback rows all carry the same placeholder confidence (0.5,
        # setup_coughvid.py:214), so the reference's stable sort keeps the
        # shuffled order and the cap takes a RANDOM subset — not a
        # confidence re-rank.
        coughs = coughs.head(max_coughs)
    else:
        coughs = (
            coughs.assign(_conf=conf_val.loc[coughs.index])
            .sort_values("_conf", ascending=False, kind="stable")
            .drop(columns="_conf")
            .head(max_coughs)
        )
    cap = int(len(coughs) * 1.5)
    if len(non_coughs) > cap:
        pick = rng.permutation(len(non_coughs))[:cap]
        non_coughs = non_coughs.iloc[pick]
    return coughs, non_coughs


def prepare_coughvid(
    coughvid_dir: str,
    output_dir: str,
    max_coughs: int = 3000,
    cough_threshold: float = 0.8,
    non_cough_threshold: float = 0.2,
    target_sr: int = 16000,
    seed: int = 42,
) -> Dict[str, int]:
    """Filter COUGHVID by annotation confidence, rank, cap, and convert to
    16 kHz mono wav (reference: setup_coughvid.py:95-289).

    Selection semantics are reference-exact (`select_coughvid`); failures
    are quarantined and COUNTED (the reference swallows them).
    """
    import pandas as pd

    src = Path(coughvid_dir)
    out = Path(output_dir)
    cough_dir = out / "cough"
    non_cough_dir = out / "non_cough"
    cough_dir.mkdir(parents=True, exist_ok=True)
    non_cough_dir.mkdir(parents=True, exist_ok=True)

    csvs = list(src.glob("**/metadata_compiled.csv")) or list(
        src.glob("**/*.csv")
    )
    if not csvs:
        raise FileNotFoundError(f"No metadata CSV under {coughvid_dir}")
    meta = pd.read_csv(csvs[0])

    uuid_to_file = {}
    for ext in (".webm", ".ogg", ".wav"):
        for f in src.glob(f"**/*{ext}"):
            uuid_to_file.setdefault(f.stem, f)

    # Select over rows whose audio actually EXISTS — the reference walks
    # the audio files and looks rows up by uuid (setup_coughvid.py:155),
    # so with a partial download its <100-cough fallback and its caps
    # see only materializable samples; selecting over raw metadata would
    # mis-trigger (or miss) the fallback and cap against phantom rows.
    n_rows = len(meta)
    if "uuid" in meta.columns:
        meta = meta[meta["uuid"].astype(str).isin(uuid_to_file.keys())]
    stats_missing = n_rows - len(meta)

    coughs, non_coughs = select_coughvid(
        meta, max_coughs, cough_threshold, non_cough_threshold, seed,
        # The reference's <100-cough fallback shuffles ALL files on disk
        # — metadata-less files included (setup_coughvid.py:209-210) —
        # not metadata rows. Sorted for a deterministic pool order (the
        # reference inherits rglob's fs-dependent order; our shuffles
        # are seeded anyway, divergence documented in docs/PARITY.md).
        fallback_uuids=sorted(uuid_to_file.keys()),
    )

    # "missing" now counts metadata rows without an audio file, excluded
    # BEFORE selection (see above); the per-row lookup below can only
    # miss if a file vanishes mid-run.
    stats = {"cough": 0, "non_cough": 0, "failed": 0,
             "missing": stats_missing}

    def convert(rows, dest, key):
        for _, row in rows.iterrows():
            f = uuid_to_file.get(str(row.get("uuid", "")))
            if f is None:
                stats["missing"] += 1
                continue
            try:
                wave, sr = audio_io.decode_audio(f)
                mono = wave.mean(axis=0, keepdims=True)
                if sr != target_sr:
                    mono = audio_io.resample_np(mono, sr, target_sr)
                audio_io.write_wav(dest / f"coughvid_{f.stem}.wav", mono, target_sr)
                stats[key] += 1
            except Exception as e:
                stats["failed"] += 1
                print(f"  quarantined {f.name}: {e}")

    convert(coughs, cough_dir, "cough")
    convert(non_coughs, non_cough_dir, "non_cough")
    print(
        f"COUGHVID: {stats['cough']} coughs, {stats['non_cough']} non-coughs, "
        f"{stats['failed']} failed, {stats['missing']} missing files"
    )
    return stats


def dataset_summary(data_dir: str) -> Dict[str, int]:
    """Count clips per class across all supported extensions
    (reference: setup_coughvid.py:490-501)."""
    out = {}
    for cls in ("cough", "non_cough"):
        d = Path(data_dir) / cls
        n = 0
        if d.exists():
            n = sum(
                1
                for f in d.iterdir()
                if f.suffix.lower() in audio_io.AUDIO_EXTENSIONS
            )
        out[cls] = n
    return out
