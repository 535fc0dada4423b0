"""The cluster's hosts file: the port's copy of vega_tpu/hosts.py.

    master = 10.0.0.1
    slaves = 10.0.0.2, 10.0.0.3:2, 10.0.0.4

A slave "host:N" runs N executors on that host (host:0 none); "#" starts
a comment. Context(mode="distributed", hosts_file=...) or
VEGA_TPU_HOSTS_FILE name it; without one the executors run on this host
(distributed/backend.py starts a remote host's executors over ssh).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

from vega_tpu_torch.errors import VegaError

DEFAULT_PATH = os.path.expanduser("~/hosts.conf")


@dataclass
class Hosts:
    master: str = "127.0.0.1"
    slaves: List[str] = field(default_factory=list)  # expanded host list

    @staticmethod
    def parse(text: str) -> "Hosts":
        master = "127.0.0.1"
        slaves: List[str] = []
        for lineno, raw in enumerate(text.splitlines(), 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" not in line:
                raise VegaError(f"hosts file line {lineno}: expected key = value")
            key, _, value = line.partition("=")
            key = key.strip().lower()
            value = value.strip()
            if key == "master":
                master = value
            elif key == "slaves":
                for entry in value.split(","):
                    entry = entry.strip()
                    if not entry:
                        continue
                    host, _, count = entry.partition(":")
                    n = 1
                    if count:
                        try:
                            n = int(count)
                        except ValueError as e:
                            raise VegaError(
                                f"hosts file line {lineno}: bad count {count!r}"
                            ) from e
                        if n < 0:
                            raise VegaError(
                                f"hosts file line {lineno}: negative count {n}"
                            )
                    slaves.extend([host] * n)  # host:0 drains the host
            else:
                raise VegaError(f"hosts file line {lineno}: unknown key {key!r}")
        return Hosts(master=master, slaves=slaves)

    @staticmethod
    def load(path: Optional[str] = None) -> "Hosts":
        """The file at path, else VEGA_TPU_HOSTS_FILE, else ~/hosts.conf;
        no file: this host alone."""
        path = path or os.environ.get("VEGA_TPU_HOSTS_FILE") or DEFAULT_PATH
        if not os.path.exists(path):
            return Hosts()
        with open(path) as f:
            return Hosts.parse(f.read())
