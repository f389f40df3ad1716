"""``harness/host.py``: the host record every result line carries."""

import os
import platform

from benchmark.harness import host


def test_mount_of_takes_the_longest_mount_point_above_the_path(tmp_path):
    mounts = tmp_path / "mounts"
    mounts.write_text(
        "rootfs / rootfs rw 0 0\n"
        "/dev/vda / ext4 rw,relatime 0 0\n"
        "tmpfs /tm tmpfs rw 0 0\n"
        f"tmpfs {tmp_path}/with\\040space tmpfs rw 0 0\n"
        f"overlay {tmp_path} overlay rw 0 0\n")
    (tmp_path / "with space" / "d").mkdir(parents=True)
    assert host.mount_of(str(tmp_path / "x"), str(mounts)) == (
        "overlay", str(tmp_path))
    assert host.mount_of(str(tmp_path / "with space" / "d"), str(mounts)) == (
        "tmpfs", str(tmp_path / "with space"))
    assert host.mount_of("/tmpx", str(mounts)) == ("ext4", "/")


def test_cpu_model_reads_cpuinfo(tmp_path):
    info = tmp_path / "cpuinfo"
    info.write_text("processor\t: 0\nmodel name\t: Some CPU @ 2.0GHz\n")
    assert host.cpu_model(str(info)) == "Some CPU @ 2.0GHz"
    other = tmp_path / "other"
    other.write_text("processor\t: 0\nmodel name\t:\nModel\t: Board 5\n")
    assert host.cpu_model(str(other)) == "Board 5"
    sandbox = tmp_path / "sandbox"
    sandbox.write_text("processor\t: 0\nvendor_id\t: GenuineIntel\n"
                       "cpu family\t: 6\nmodel\t\t: 207\n"
                       "model name\t: unknown\n")
    assert host.cpu_model(str(sandbox)) == "GenuineIntel family 6 model 207"
    assert host.cpu_model(str(tmp_path / "none")) == platform.machine()


def test_record_of_a_store_directory(tmp_path):
    rec = host.record(str(tmp_path))
    assert set(rec) == {"cpu", "cpus", "store_fs", "store_mount",
                        "o_direct", "load1"}
    assert rec["cpus"] == len(os.sched_getaffinity(0)) >= 1
    assert isinstance(rec["o_direct"], bool)
    assert os.listdir(tmp_path) == []  # the probe file is gone
