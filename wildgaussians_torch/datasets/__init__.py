"""Dataset loading facade: the port's copy of
`wildgaussians_tpu/datasets/__init__.py`."""
import logging
from pathlib import Path
from typing import FrozenSet, Optional, Union

from ..types import DatasetFeature, UnloadedDataset
from .common import (DatasetNotFoundError, dataset_index_select,  # noqa: F401
                     dataset_load_features, new_dataset)

logger = logging.getLogger(__name__)


def load_dataset(path: Union[Path, str],
                 split: str,
                 features: Optional[FrozenSet[DatasetFeature]] = None,
                 **kwargs) -> UnloadedDataset:
    """Try the specialized loaders in order (phototourism -> colmap).

    An `external://<dataset>` path names a scene in the local cache
    ($WG_PREFIX/datasets/<dataset>, default ~/.cache/wildgaussians-tpu); a
    scene that is not there raises DatasetNotFoundError, and nothing is
    downloaded."""
    path = str(path)
    errors = {}
    from .phototourism import load_phototourism_dataset
    from .colmap import load_colmap_dataset
    if path.startswith("external://"):
        import os
        name = path.split("://", 1)[1]
        prefix = os.environ.get(
            "WG_PREFIX", os.path.expanduser("~/.cache/wildgaussians-tpu"))
        local = Path(prefix) / "datasets" / name
        if not local.exists():
            from .phototourism import download_phototourism_dataset
            download_phototourism_dataset(name, local)
        path = str(local)
    for name, loader in (("phototourism", load_phototourism_dataset),
                         ("colmap", load_colmap_dataset)):
        try:
            dataset = loader(path, split=split, features=features, **kwargs)
            logger.info("Loaded %s dataset from %s", name, path)
            return dataset
        except DatasetNotFoundError as e:
            errors[name] = str(e)
    raise DatasetNotFoundError(
        f"Could not load dataset from {path}:\n"
        + "\n".join(f"  {k}: {v}" for k, v in errors.items()))
