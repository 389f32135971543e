"""Testbed settings (reference ``benchmark/benchmark/settings.py``):
same ``settings.json`` schema — testbed name, ssh key, port layout
(consensus/mempool/front), repo, instance type, AWS regions.

Port copy of the reference's ``benchmark/settings.py``, unchanged: the same
fields, the same ``load`` (``settings.json`` in the working directory by
default) and the same ``SettingsError`` on a missing key or file. The
template ``settings.json`` beside this module is a byte-for-byte copy of
the reference's ``benchmark/settings.json``. ``fabfile``'s ``remote``,
``create``, ``destroy`` and ``kill`` tasks read it.
"""

from __future__ import annotations

import json


class SettingsError(Exception):
    pass


class Settings:
    def __init__(
        self,
        testbed: str,
        key_name: str,
        key_path: str,
        consensus_port: int,
        mempool_port: int,
        front_port: int,
        repo_name: str,
        repo_url: str,
        branch: str,
        instance_type: str,
        aws_regions: list[str],
    ) -> None:
        self.testbed = testbed
        self.key_name = key_name
        self.key_path = key_path
        self.consensus_port = consensus_port
        self.mempool_port = mempool_port
        self.front_port = front_port
        self.repo_name = repo_name
        self.repo_url = repo_url
        self.branch = branch
        self.instance_type = instance_type
        self.aws_regions = aws_regions

    @classmethod
    def load(cls, filename: str = "settings.json") -> "Settings":
        try:
            with open(filename) as f:
                data = json.load(f)
            return cls(
                testbed=data["testbed"],
                key_name=data["key"]["name"],
                key_path=data["key"]["path"],
                consensus_port=int(data["ports"]["consensus"]),
                mempool_port=int(data["ports"]["mempool"]),
                front_port=int(data["ports"]["front"]),
                repo_name=data["repo"]["name"],
                repo_url=data["repo"]["url"],
                branch=data["repo"]["branch"],
                instance_type=data["instances"]["type"],
                aws_regions=list(data["instances"]["regions"]),
            )
        except (OSError, KeyError, ValueError) as e:
            raise SettingsError(f"failed to load settings '{filename}': {e}") from e
