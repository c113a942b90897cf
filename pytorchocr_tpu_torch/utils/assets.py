"""Character-dictionary path resolution — the port's copy of
pytorchocr_tpu/utils/assets.py:19 (`resolve_dict_path`).

The configs name `character_dict_path` relative to the repository root
(`./pytorchocr_tpu/utils/char_dict_6623.txt`). A path that does not exist from
the working directory falls back to the file of the same basename in the
directory that holds the charsets, `pytorchocr_tpu/utils/` of this checkout:
the dictionaries are data files read there, not code imported.
"""

import os

ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "pytorchocr_tpu", "utils",
)


def resolve_dict_path(path):
    """Return `path` if it exists, else the charset with the same basename
    in ASSET_DIR (if any), else `path` unchanged (open() then raises
    FileNotFoundError). From assets.py:19."""
    if path is None or os.path.exists(path):
        return path
    candidate = os.path.join(ASSET_DIR, os.path.basename(str(path)))
    if os.path.exists(candidate):
        return candidate
    return path
