"""Dataset session tooling (counterpart of the JAX package's data/sessions.py,
of which it is a copy; reference: Assets/Editor/TrainingManagerEditor.cs:40-64).

`consolidate_sessions` merges multiple generation-session directories into
one, renumbering sample ids so file sets stay aligned — the reference's
"Consolidate Sessions" inspector button.
"""

from __future__ import annotations

import os
import re
import shutil

_ID_RE = re.compile(r"^(?P<stem>.+)_(?P<sid>\d{5})\.(?P<ext>[A-Za-z]+)$")


def list_sample_ids(session_dir: str) -> list[int]:
    ids = set()
    for f in os.listdir(session_dir):
        m = _ID_RE.match(f)
        if m and m.group("stem").startswith("Scene"):
            ids.add(int(m.group("sid")))
    return sorted(ids)


def sample_files(session_dir: str, sid: int) -> list[str]:
    out = []
    for f in os.listdir(session_dir):
        m = _ID_RE.match(f)
        if m and int(m.group("sid")) == sid:
            out.append(f)
    return sorted(out)


def is_complete(session_dir: str, sid: int, n_input_profiles: int) -> bool:
    files = set(sample_files(session_dir, sid))
    needed = [f"Scene_{sid:05d}.json", f"Albedo_{sid:05d}.png",
              f"Transmissibility_{sid:05d}.exr",
              f"Output_Reference_{sid:05d}.exr"]
    needed += [f"Input{k}_Radiance_{t}_{sid:05d}.exr"
               for k in range(n_input_profiles) for t in "AB"]
    return all(n in files for n in needed)


def consolidate_sessions(output_folder: str, dest_name: str = "consolidated",
                         n_input_profiles: int = 3, move: bool = False) -> str:
    """Merge all session dirs under output_folder into one, renumbering
    complete samples contiguously. Returns the destination path."""
    dest = os.path.join(output_folder, dest_name)
    os.makedirs(dest, exist_ok=True)
    next_id = (max(list_sample_ids(dest)) + 1) if list_sample_ids(dest) else 0

    sessions = sorted(
        d for d in os.listdir(output_folder)
        if os.path.isdir(os.path.join(output_folder, d)) and d != dest_name)
    for sess in sessions:
        sdir = os.path.join(output_folder, sess)
        for sid in list_sample_ids(sdir):
            if not is_complete(sdir, sid, n_input_profiles):
                continue
            for f in sample_files(sdir, sid):
                m = _ID_RE.match(f)
                new = f"{m.group('stem')}_{next_id:05d}.{m.group('ext')}"
                src = os.path.join(sdir, f)
                dst = os.path.join(dest, new)
                (shutil.move if move else shutil.copy2)(src, dst)
            next_id += 1
    return dest
