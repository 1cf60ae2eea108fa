"""``chaos/link.py``, the link-shaping layer: the port against the JAX package.

The reference's ``tests/test_chaos_link.py`` cases (all but the socket
transport's): per-edge RNG streams, loss, duplication, bandwidth
serialization, the backlog signal, partitions in hold and drop mode,
scaling and the presets.  Each case runs in both packages and returns every
shaping decision and the shaper's counters; the port also keeps the counters
under the reference's ``hbbft_chaos_*`` metric names.  Then the simulator's
side of the hook: a ``VirtualNet`` under each preset delivers in the
reference's order, and ``EclipseAdversary``/``VoteStormAdversary`` read
``quiescent`` (the live queue and the held set both empty).

Tolerance: exact (every delay is the same float).
"""

import pytest

from test_torch_obj_protocols import PORT, REF
from test_torch_sender_queue import SHAPES, x


def _decisions(shaper, n=200, edge=("a", "b"), now=0.0, nbytes=100):
    return [shaper.shape_frame(edge[0], edge[1], now, nbytes=nbytes) for _ in range(n)]


def seeds(link):
    shape = link.NetShape(default=link.ShapedLink(delay_s=0.01, jitter_s=0.02, loss=0.1, dup=0.1))
    a = _decisions(link.LinkShaper(shape, seed=7))
    b = _decisions(link.LinkShaper(shape, seed=7))
    c = _decisions(link.LinkShaper(shape, seed=8))
    assert a == b and a != c
    return a, c


def independent_edges(link):
    shape = link.NetShape(default=link.ShapedLink(jitter_s=0.5))
    s1, s2 = link.LinkShaper(shape, seed=3), link.LinkShaper(shape, seed=3)
    seq1 = []
    for _ in range(50):
        seq1.append(s1.shape_frame(0, 1, 0.0))
        s1.shape_frame(2, 3, 0.0)
    seq2 = [s2.shape_frame(0, 1, 0.0) for _ in range(50)]
    assert seq1 == seq2
    return seq1, s1.stats()


def unshaped_edge(link):
    shaper = link.LinkShaper(link.NetShape(edges={(0, 1): link.ShapedLink()}))
    assert shaper.shape_frame(1, 0, 0.0) is None and shaper.stats()["shaped"] == 0
    assert shaper.shape_frame(0, 1, 0.0) == [0.0] and shaper.stats()["shaped"] == 1
    return shaper.stats()


def loss(link):
    shaper = link.LinkShaper(link.NetShape(default=link.ShapedLink(loss=1.0)), seed=1)
    assert shaper.shape_frame(0, 1, 0.0) == [] and shaper.stats()["dropped"] == 1
    return shaper.stats()


def duplication(link):
    shaper = link.LinkShaper(link.NetShape(default=link.ShapedLink(dup=1.0, delay_s=0.01)),
                             seed=1)
    delays = shaper.shape_frame(0, 1, 0.0)
    assert len(delays) == 2 and delays[0] != delays[1]
    assert shaper.stats()["duplicated"] == 1
    return delays, shaper.stats()


def bandwidth(link):
    lk = link.ShapedLink(bandwidth_bps=8000.0)
    assert lk.needs_size
    shaper = link.LinkShaper(link.NetShape(default=lk))
    out = [shaper.shape_frame(0, 1, 0.0, nbytes=100), shaper.shape_frame(0, 1, 0.0, nbytes=100),
           shaper.shape_frame(0, 2, 0.0, nbytes=100), shaper.shape_frame(0, 1, 10.0, nbytes=100)]
    assert out == [[pytest.approx(0.1)], [pytest.approx(0.2)], [pytest.approx(0.1)],
                   [pytest.approx(0.1)]]
    # a size_fn is read only when the policy needs a size and none is given
    calls = []
    out.append(shaper.shape_frame(3, 4, 0.0, size_fn=lambda: calls.append(1) or 50))
    assert calls == [1]
    return out, shaper.stats()


def backlog(link):
    shaper = link.LinkShaper(link.NetShape(default=link.ShapedLink(bandwidth_bps=8000.0)))
    out = [shaper.backlog_s(0, 1, 0.0)]
    shaper.shape_frame(0, 1, 0.0, nbytes=100)
    shaper.shape_frame(0, 1, 0.0, nbytes=100)
    out += [shaper.backlog_s(0, 1, t) for t in (0.0, 0.15, 5.0)] + [shaper.backlog_s(1, 0, 0.0)]
    assert out == [0.0, pytest.approx(0.2), pytest.approx(0.05), 0.0, 0.0]
    return out


def partition_hold(link):
    shaper = link.LinkShaper(link.NetShape(default=link.ShapedLink(partitions=((1.0, 3.0),))))
    out = [shaper.shape_frame(0, 1, t) for t in (0.5, 1.5, 3.0)]
    assert out == [[0.0], [pytest.approx(1.5)], [0.0]]
    assert shaper.stats()["partition_holds"] == 1 and shaper.stats()["dropped"] == 0
    return out, shaper.stats()


def partition_drop(link):
    shaper = link.LinkShaper(link.NetShape(default=link.ShapedLink(
        partitions=((1.0, 3.0),), partition_mode="drop")))
    assert shaper.shape_frame(0, 1, 2.0) == [] and shaper.stats()["dropped"] == 1
    return shaper.stats()


def scaled(link):
    lk = link.ShapedLink(delay_s=1.0, jitter_s=2.0, reorder_spread_s=4.0,
                         bandwidth_bps=8000.0, partitions=((10.0, 20.0),))
    s = lk.scaled(0.001)
    assert s.delay_s == pytest.approx(0.001) and s.jitter_s == pytest.approx(0.002)
    assert s.reorder_spread_s == pytest.approx(0.004)
    assert 8.0 * 100 / s.bandwidth_bps == pytest.approx(0.001 * 8.0 * 100 / lk.bandwidth_bps)
    lossy = link.ShapedLink(loss=0.25, dup=0.5).scaled(0.001)
    assert lossy.loss == 0.25 and lossy.dup == 0.5
    shape = link.NetShape(default=lk, edges={(0, 1): lossy}).scaled(0.5)
    return repr(s), repr(lossy), repr(shape)


def presets(link):
    out = {}
    for name in link.PRESETS + ("bandwidth-asym",):
        shape = link.preset_shape(name, 4)
        if name != "none":
            assert shape.default is not None or shape.edges, name
        out[name] = repr(shape)
    with pytest.raises(ValueError, match="unknown chaos preset"):
        link.preset_shape("nope", 4)
    shape = link.preset_shape("partition-10s", 4)
    assert shape.policy_for(3, 0).partitions and shape.policy_for(0, 3).partitions
    assert not shape.policy_for(0, 1).partitions
    asym = link.preset_shape("bandwidth-asym", 22)
    assert asym.policy_for(21, 0).bandwidth_bps == 8.0 * 64 * 1024
    assert asym.policy_for(0, 1) is None
    out["isolate"] = repr(link._isolate(5, 1, link.ShapedLink(loss=0.5)))
    return out


def every_preset_stream(link):
    """A mixed stream through every preset: each edge's decisions and the
    counters, at the virtual clock's scale."""
    out = {}
    for name in link.PRESETS + ("bandwidth-asym",):
        shaper = link.LinkShaper(link.preset_shape(name, 4).scaled(1e-3), seed=9)
        out[name] = ([shaper.shape_frame(s, d, 0.0007 * i, nbytes=40 + 13 * i)
                      for i in range(300) for s, d in ((i % 4, (i + 1) % 4), (3, i % 3))],
                     shaper.stats())
    return out


CASES = {f.__name__: f for f in (
    seeds, independent_edges, unshaped_edge, loss, duplication, bandwidth, backlog,
    partition_hold, partition_drop, scaled, presets, every_preset_stream)}


@pytest.mark.parametrize("name", list(CASES))
def test_link_case_matches_reference(name):
    case = CASES[name]
    assert case(x(PORT).link) == case(x(REF).link)


def test_counters_keep_the_metric_names():
    link = x(PORT).link
    shaper = link.LinkShaper(link.NetShape(default=link.ShapedLink(
        dup=1.0, delay_s=0.01, partitions=((1.0, 2.0),))), seed=2)
    shaper.shape_frame(0, 1, 0.0)
    shaper.shape_frame(0, 1, 1.5)
    assert shaper.counters == {
        "hbbft_chaos_frames_shaped_total": 2, "hbbft_chaos_frames_dropped_total": 0,
        "hbbft_chaos_frames_delayed_total": 2, "hbbft_chaos_frames_duplicated_total": 1,
        "hbbft_chaos_partition_holds_total": 1}
    assert shaper.stats() == {"shaped": 2, "dropped": 0, "delayed": 2, "duplicated": 1,
                              "partition_holds": 1}


# -- the simulator's side of the hook ----------------------------------------


def shaped_stream(p, shape):
    """A broadcast on a shaped net: the delivery order, each message's
    release time, the virtual clock and the held set as it drains."""
    from test_torch_obj_protocols import infos

    nets = infos(p, 4)
    b = p.sim.NetBuilder(list(range(4))).cost_model(p.sim.CostModel())
    if shape is not None:
        b = b.shape(x(p).link.preset_shape(shape, 4).scaled(1e-3), seed=3)
    net = b.using_step(lambda nid: p.bc.Broadcast(nets[nid], 0, **p.kw))
    net.send_input(0, bytes(range(256)) * 8)
    order = []
    while True:
        held = len(net._held)
        msg = net.crank()
        if msg is None:
            break
        order.append((msg.sender, msg.to, msg.at, held, net.virtual_time))
    assert net.quiescent
    return order, None if net.shaper is None else net.shaper.stats()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s or "unshaped")
def test_shaped_virtual_net_matches_reference(shape):
    ref, got = shaped_stream(REF, shape), shaped_stream(PORT, shape)
    assert got == ref
    if shape is None:
        assert all(at == 0.0 and held == 0 for _, _, at, held, _ in got[0])


def test_shaper_builder_takes_a_prebuilt_shaper():
    link = x(PORT).link
    shaper = link.LinkShaper(link.preset_shape("wan-100ms", 4), seed=4)
    net = PORT.sim.NetBuilder([0, 1]).shape(shaper).using_step(lambda nid: None)
    assert net.shaper is shaper
