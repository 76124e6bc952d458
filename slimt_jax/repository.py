"""Model repositories: translateLocally / OPUS-style inventories.

Mirrors the reference python package's repository layer
(bindings/python/repository.py): a `Repository` interface with a
translateLocally-like implementation that keeps a `models.json`
inventory, per-model directories, and tar.gz unpacking. Network fetch
degrades gracefully when offline (inventories/archives can be placed
in the cache directories manually — or synthesized for testing).

Directory layout (XDG-style, no appdirs dependency):
    ~/.local/share/slimt_jax/<repo>/models/<code>/   unpacked models
    ~/.config/slimt_jax/<repo>/models.json           inventory
    ~/.cache/slimt_jax/<repo>/archives/              downloads
"""

from __future__ import annotations

import json
import os
import tarfile
import urllib.request
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

APP = "slimt_jax"


def _xdg(env: str, default: str) -> str:
    return os.environ.get(env) or os.path.expanduser(default)


class Repository(ABC):
    @property
    @abstractmethod
    def name(self) -> str: ...

    @abstractmethod
    def update(self) -> None: ...

    @abstractmethod
    def models(self, filter_downloaded: bool = True) -> List[str]: ...

    @abstractmethod
    def model(self, model_identifier: str) -> Any: ...

    @abstractmethod
    def model_config_path(self, model_identifier: str) -> str: ...

    @abstractmethod
    def download(self, model_identifier: str) -> None: ...


class TranslateLocallyLike(Repository):
    def __init__(self, name: str, url: str, root: Optional[str] = None):
        self.url = url
        self._name = name
        base_data = root or _xdg("XDG_DATA_HOME", "~/.local/share")
        base_config = root or _xdg("XDG_CONFIG_HOME", "~/.config")
        base_cache = root or _xdg("XDG_CACHE_HOME", "~/.cache")
        join = os.path.join
        self.dirs = {
            "data": join(base_data, APP, name),
            "config": join(base_config, APP, name),
            "cache": join(base_cache, APP, name),
        }
        self.dirs["models"] = join(self.dirs["data"], "models")
        self.dirs["archive"] = join(self.dirs["cache"], "archives")
        for directory in self.dirs.values():
            os.makedirs(directory, exist_ok=True)

        self.models_file_path = join(self.dirs["config"], "models.json")
        self.data = self._load_data()
        self.data_by_code = {
            model["code"]: model for model in self.data.get("models", [])
        }

    @property
    def name(self) -> str:
        return self._name

    def _load_data(self) -> Dict:
        if os.path.exists(self.models_file_path):
            with open(self.models_file_path) as f:
                return json.load(f)
        try:
            self.update()
            with open(self.models_file_path) as f:
                return json.load(f)
        except Exception:
            # Offline: empty inventory; user can drop models.json in.
            return {"models": []}

    def update(self) -> None:
        with urllib.request.urlopen(self.url) as response:
            inventory = response.read().decode("utf-8")
        with open(self.models_file_path, "w") as f:
            f.write(inventory)

    def models(self, filter_downloaded: bool = True) -> List[str]:
        codes = []
        for model in self.data.get("models", []):
            code = model["code"]
            if filter_downloaded:
                if os.path.exists(os.path.join(self.dirs["models"], code)):
                    codes.append(code)
            else:
                codes.append(code)
        return codes

    def model(self, model_identifier: str) -> Any:
        return self.data_by_code.get(model_identifier)

    def model_config_path(self, model_identifier: str) -> str:
        model_dir = os.path.join(self.dirs["models"], model_identifier)
        for sub in sorted(os.listdir(model_dir)) if os.path.isdir(model_dir) else []:
            candidate = os.path.join(model_dir, sub)
            if os.path.isdir(candidate):
                model_dir = candidate
                break
        for name in sorted(os.listdir(model_dir)) if os.path.isdir(model_dir) else []:
            if name.startswith("config") and name.endswith((".yml", ".yaml")):
                return os.path.join(model_dir, name)
        raise FileNotFoundError(
            f"no config.*.yml under {model_dir}; is {model_identifier} "
            "downloaded?"
        )

    def download(self, model_identifier: str) -> None:
        entry = self.model(model_identifier)
        if entry is None:
            raise KeyError(f"unknown model {model_identifier!r}")
        url = entry["url"]
        archive = os.path.join(
            self.dirs["archive"], os.path.basename(url)
        )
        if not os.path.exists(archive):
            urllib.request.urlretrieve(url, filename=archive)
        target = os.path.join(self.dirs["models"], model_identifier)
        os.makedirs(target, exist_ok=True)
        with tarfile.open(archive) as tar:
            tar.extractall(path=target, filter="data")


_REPOSITORIES: Dict[str, Repository] = {}


def default_repositories() -> Dict[str, Repository]:
    """The inventories the reference ships (repository.py:124-139)."""
    if not _REPOSITORIES:
        _REPOSITORIES.update(
            {
                "browsermt": TranslateLocallyLike(
                    "browsermt",
                    "https://translatelocally.com/models.json",
                ),
                "opus": TranslateLocallyLike(
                    "opus",
                    "https://object.pouta.csc.fi/OPUS-MT-models/app/models.json",
                ),
            }
        )
    return _REPOSITORIES
