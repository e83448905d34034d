"""make_mesh's groups form with the agreed retry (parallel/mesh.py
new_group_agreed), as the default group does (init_file_group,
tests/test_torch_traffic_table.py): gloo's "Connection closed by peer"
while a group connects is retried, at most INIT_TRIES times, with every
rank leaving a failed try together; any other error raises on every
rank. Ranks are threads here, with a stand-in dist.new_group and one
in-memory control store; the last test drives make_mesh itself on a
gloo group of one whose first new_group drops.
"""

import threading

import pytest
import torch
import torch.distributed as dist

from cafe_tpu_torch.parallel import mesh as mesh_mod

torch.set_num_threads(1)

DROPPED = "[enforce fail] Connection closed by peer [127.0.0.1]:1"


def _fake_new_group(monkeypatch, fails):
    """dist.new_group / destroy_process_group stand-ins for ranks that
    are threads (each sets `local.rank`): `fails` {(rank, try): message}
    raise; returns the groups each rank made and those destroyed."""
    local = threading.local()
    made, destroyed = {}, []

    def new_group(ranks, backend=None):
        attempt = len(made.setdefault(local.rank, []))
        if (local.rank, attempt) in fails:
            made[local.rank].append(None)
            raise RuntimeError(fails[local.rank, attempt])
        group = (local.rank, attempt)
        made[local.rank].append(group)
        return group

    monkeypatch.setattr(dist, "new_group", new_group)
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda g=None: destroyed.append(g))
    return local, made, destroyed


def _ranks(local, world):
    store = dist.HashStore()
    results, errors = {}, {}

    def one(rank):
        local.rank = rank
        try:
            results[rank] = mesh_mod.new_group_agreed(
                list(range(world)), "gloo", store, "mesh0/0/", rank, world)
        except RuntimeError as e:
            errors[rank] = str(e)

    threads = [threading.Thread(target=one, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return results, errors


def test_new_group_retries_a_dropped_connection(monkeypatch):
    """Rank 1's first try drops: both ranks leave it (rank 0, whose group
    formed, destroys it) and both keep the second try's group."""
    local, made, destroyed = _fake_new_group(monkeypatch,
                                             {(1, 0): DROPPED})
    results, errors = _ranks(local, 2)
    assert errors == {}
    assert results == {0: (0, 1), 1: (1, 1)}
    assert destroyed == [(0, 0)]
    assert {r: len(v) for r, v in made.items()} == {0: 2, 1: 2}


def test_new_group_raises_other_errors(monkeypatch):
    """Any other error ends the group on every rank, with no retry."""
    local, made, _ = _fake_new_group(monkeypatch,
                                     {(0, 0): "address in use"})
    results, errors = _ranks(local, 2)
    assert results == {}
    assert errors[0] == "address in use"
    assert "did not form" in errors[1]
    assert all(len(v) == 1 for v in made.values())


def test_new_group_tries_a_bounded_number_of_times(monkeypatch):
    local, made, _ = _fake_new_group(
        monkeypatch, {(0, t): DROPPED for t in range(10)})
    _, errors = _ranks(local, 1)
    assert "did not form" in errors[0]
    assert len(made[0]) == mesh_mod.INIT_TRIES


@pytest.fixture
def group_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_retries_its_groups(monkeypatch, group_of_one):
    """make_mesh's first new_group drops: the mesh forms on the second
    try, the ranks' host names gathered."""
    real, calls = dist.new_group, []

    def new_group(ranks, backend=None):
        calls.append(list(ranks))
        if len(calls) == 1:
            raise RuntimeError(DROPPED)
        return real(ranks, backend=backend)

    monkeypatch.setattr(dist, "new_group", new_group)
    mesh = mesh_mod.make_mesh(1, device="cpu")
    try:
        assert calls == [[0], [0]]
        assert mesh.size == 1 and len(mesh.hosts) == 1
    finally:
        mesh.close()
