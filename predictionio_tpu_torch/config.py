"""Layered infrastructure configuration.

Port of ``predictionio_tpu/config.py`` (reference: conf/pio-env.sh.template
and Storage.scala's ``StorageClientConfig`` env parsing).  The contract
is the reference's::

    PIO_STORAGE_REPOSITORIES_{METADATA,EVENTDATA,MODELDATA}_{NAME,SOURCE}
    PIO_STORAGE_SOURCES_<SOURCE>_{TYPE,HOSTS,PORTS,PATH,...}

with an optional TOML file (``$PIO_HOME/pio-env.toml`` or
``$PIO_CONFIG_FILE``) and fully local defaults, the same as the
reference's:

- METADATA  → sqlite  at ``$PIO_HOME/storage/pio.db``
- EVENTDATA → sqlite  at ``$PIO_HOME/storage/pio.db``
- MODELDATA → localfs at ``$PIO_HOME/storage/models``

Precedence: env > TOML file > defaults.  :func:`memory_config` is the
port's own addition: every repository on the in-process ``MEMORY``
source, for one-process runs and tests.
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Mapping, Optional, Union

__all__ = ["StorageSourceConfig", "RepositoryConfig", "PioConfig",
           "load_config", "memory_config", "pio_home", "env_bool"]

_REPOSITORIES = ("METADATA", "EVENTDATA", "MODELDATA")


def env_bool(raw: Optional[str], default: bool) -> bool:
    """The boolean env-var dialect (``PIO_FOLD_IN``, ...): unset or empty
    is ``default``; anything but ``0/off/false/no`` (any case) is
    true."""
    if raw is None or raw.strip() == "":
        return default
    return raw.strip().lower() not in ("0", "off", "false", "no")


def pio_home(env: Optional[Mapping[str, str]] = None) -> Path:
    """``PIO_HOME``, else ``~/.predictionio_tpu``."""
    env = env if env is not None else os.environ
    home = env.get("PIO_HOME")
    if home:
        return Path(home)
    return Path(env.get("HOME", "/tmp")) / ".predictionio_tpu"


@dataclass(frozen=True)
class StorageSourceConfig:
    """One named storage source (reference: StorageClientConfig)."""

    name: str
    type: str                      # sqlite | localfs | memory
    properties: Dict[str, str] = field(default_factory=dict)

    @property
    def path(self) -> Optional[str]:
        return self.properties.get("PATH")


@dataclass(frozen=True)
class RepositoryConfig:
    """Binding of a logical repository to a source."""

    repo: str                      # METADATA | EVENTDATA | MODELDATA
    namespace: str                 # table prefix (reference: _NAME)
    source: str                    # source name (reference: _SOURCE)


@dataclass(frozen=True)
class PioConfig:
    home: Path
    sources: Dict[str, StorageSourceConfig]
    repositories: Dict[str, RepositoryConfig]
    extra: Dict[str, str] = field(default_factory=dict)

    def source_for(self, repo: str) -> StorageSourceConfig:
        rc = self.repositories[repo.upper()]
        try:
            return self.sources[rc.source]
        except KeyError:
            raise KeyError(
                f"Repository {repo} points at undefined storage source "
                f"{rc.source!r}; defined sources: {sorted(self.sources)}"
            ) from None


def _defaults(home: Path) -> Dict[str, str]:
    storage = home / "storage"
    return {
        "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "pio_meta",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQLITE",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "pio_event",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQLITE",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "pio_model",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "LOCALFS",
        "PIO_STORAGE_SOURCES_SQLITE_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQLITE_PATH": str(storage / "pio.db"),
        "PIO_STORAGE_SOURCES_PARQUET_TYPE": "parquetlog",
        "PIO_STORAGE_SOURCES_PARQUET_PATH": str(storage / "events"),
        "PIO_STORAGE_SOURCES_LOCALFS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_LOCALFS_PATH": str(storage / "models"),
        "PIO_STORAGE_SOURCES_MEMORY_TYPE": "memory",
    }


def _load_toml(path: Path) -> Dict[str, str]:
    """Flatten a TOML file into PIO_* env-style keys: literal env keys
    under ``[env]``, or structured::

        [storage.repositories.eventdata]
        name = "pio_event"
        source = "SQLITE"
        [storage.sources.SQLITE]
        type = "sqlite"
        path = "/data/pio.db"
    """
    with open(path, "rb") as f:
        doc = tomllib.load(f)
    flat: Dict[str, str] = {}
    for k, v in (doc.get("env") or {}).items():
        flat[str(k)] = str(v)
    storage = doc.get("storage") or {}
    for repo, spec in (storage.get("repositories") or {}).items():
        up = repo.upper()
        if "name" in spec:
            flat[f"PIO_STORAGE_REPOSITORIES_{up}_NAME"] = str(spec["name"])
        if "source" in spec:
            flat[f"PIO_STORAGE_REPOSITORIES_{up}_SOURCE"] = \
                str(spec["source"]).upper()
    for src, spec in (storage.get("sources") or {}).items():
        up = src.upper()
        for pk, pv in spec.items():
            flat[f"PIO_STORAGE_SOURCES_{up}_{pk.upper()}"] = str(pv)
    return flat


def _resolve(merged: Mapping[str, str], home: Path) -> PioConfig:
    sources: Dict[str, StorageSourceConfig] = {}
    prefix = "PIO_STORAGE_SOURCES_"
    names = {key[len(prefix):-len("_TYPE")] for key in merged
             if key.startswith(prefix) and key.endswith("_TYPE")}
    for name in names:
        p = f"{prefix}{name}_"
        props = {key[len(p):]: val for key, val in merged.items()
                 if key.startswith(p) and key != f"{p}TYPE"}
        sources[name] = StorageSourceConfig(
            name=name, type=merged[f"{p}TYPE"], properties=props)
    repositories = {
        repo: RepositoryConfig(
            repo=repo,
            namespace=merged[f"PIO_STORAGE_REPOSITORIES_{repo}_NAME"],
            source=merged[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"].upper())
        for repo in _REPOSITORIES
    }
    extra = {k: v for k, v in merged.items()
             if k.startswith("PIO_") and not k.startswith(
                 ("PIO_STORAGE_REPOSITORIES_", "PIO_STORAGE_SOURCES_"))}
    return PioConfig(home=home, sources=sources, repositories=repositories,
                     extra=extra)


def load_config(
    env: Optional[Mapping[str, str]] = None,
    config_file: Optional[os.PathLike] = None,
) -> PioConfig:
    """Resolve config with precedence env > TOML file > defaults."""
    env = dict(env if env is not None else os.environ)
    home = pio_home(env)
    merged = _defaults(home)
    toml_path = Path(config_file) if config_file else None
    if toml_path is None:
        cand = env.get("PIO_CONFIG_FILE")
        if cand:
            toml_path = Path(cand)
        elif (home / "pio-env.toml").exists():
            toml_path = home / "pio-env.toml"
    if toml_path is not None and toml_path.exists():
        merged.update(_load_toml(toml_path))
    merged.update({k: v for k, v in env.items() if k.startswith("PIO_")})
    return _resolve(merged, home)


def memory_config(home: Union[str, os.PathLike]) -> PioConfig:
    """Every repository on the in-process ``MEMORY`` source, rooted at
    ``home``; the environment is not read.  A :class:`~predictionio_tpu_
    torch.data.storage.Storage` built on it lives and dies with its
    process, so the same object must reach whatever inserts events,
    ``run_train`` and the server."""
    home = Path(home)
    merged = _defaults(home)
    for repo in _REPOSITORIES:
        merged[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "MEMORY"
    return _resolve(merged, home)
