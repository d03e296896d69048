"""Path registry (JAX ``dirs.py``, the reference's ``dirs.py``): where the
data, the train split, the pretrained encoders' checkpoints and the results
live.

The JAX package reads each location from an environment variable; here each
is an argument of ``dirs``, which reads no environment. With no arguments the
paths are the JAX package's defaults, under the repository's root. Nothing is
created until ``ensure_dirs`` is called.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

#: the repository's root (the directory that holds this package)
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


class Dirs(NamedTuple):
    root: str
    data_dir: str
    pop909_data_dir: str
    musicalion_data_dir: str
    train_split_dir: str
    pretrained_dir: str
    pt_chd_8bar_path: str
    pt_polydis_path: str
    pt_pnotree_path: str
    result_dir: str


def dirs(
    root: Optional[str] = None,
    *,
    data_dir: Optional[str] = None,
    pop909_data_dir: Optional[str] = None,
    musicalion_data_dir: Optional[str] = None,
    train_split_dir: Optional[str] = None,
    pretrained_dir: Optional[str] = None,
    result_dir: Optional[str] = None,
) -> Dirs:
    """The paths under ``root`` (default ``ROOT``); each argument overrides
    what the JAX package's variable of the same name overrides
    (``POLYFFUSION_ROOT``, ``POLYFFUSION_DATA_DIR``, ``POP909_DATA_DIR``,
    ``MUSICALION_DATA_DIR``, ``TRAIN_SPLIT_DIR``, ``PRETRAINED_DIR``,
    ``POLYFFUSION_RESULT_DIR``), and the paths below it follow it."""
    root = root or ROOT
    data_dir = data_dir or os.path.join(root, "data")
    pretrained_dir = pretrained_dir or os.path.join(root, "pretrained")
    return Dirs(
        root=root,
        data_dir=data_dir,
        pop909_data_dir=pop909_data_dir or os.path.join(data_dir, "POP909_4_bin_pnt_8bar"),
        musicalion_data_dir=(musicalion_data_dir
                             or os.path.join(data_dir, "musicalion_solo_piano")),
        train_split_dir=train_split_dir or os.path.join(data_dir, "train_split_pnt"),
        pretrained_dir=pretrained_dir,
        pt_chd_8bar_path=os.path.join(pretrained_dir, "chd8bar.pt"),
        pt_polydis_path=os.path.join(pretrained_dir, "polydis.pt"),
        pt_pnotree_path=os.path.join(pretrained_dir, "pnotree.pt"),
        result_dir=result_dir or os.path.join(root, "result"),
    )


def ensure_dirs(d: Dirs) -> None:
    """Create the data, train-split and result directories of ``d``."""
    for path in (d.data_dir, d.train_split_dir, d.result_dir):
        os.makedirs(path, exist_ok=True)
