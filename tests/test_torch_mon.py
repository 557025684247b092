"""The port's monitor elector, driven with a stand-in monitor (as
tests/test_mon.py drives the reference's), so no timer or socket decides
the outcome."""
from ceph_tpu_torch.mon.elector import Elector
from ceph_tpu_torch.mon.messages import MMonElection


class _FakeMon:
    def __init__(self, rank, n=3):
        self.rank = rank
        self.monmap = type("MM", (), {"ranks": lambda s: list(range(n))})()
        self.sent = []  # (rank, msg)
        self.won = None
        self.lost = None

    def majority(self):
        return len(self.monmap.ranks()) // 2 + 1

    def other_ranks(self):
        return [r for r in self.monmap.ranks() if r != self.rank]

    def set_electing(self):
        pass

    def send_mon(self, rank, msg):
        self.sent.append((rank, msg))

    def win_election(self, epoch, quorum):
        self.won = (epoch, quorum)

    def lose_election(self, epoch, leader, quorum):
        self.lost = (epoch, leader, quorum)


def test_two_victories_at_one_epoch_elect_again():
    """mon.0's proposal never reached mon.1 (not up yet), and mon.2 acked
    both: each declares victory at epoch 4.  Taking the other's victory
    made each the other's peon and left no leader (seen on an H100 run of
    chip_smoke.py); a conflicting victory must start a new election."""
    mon0 = _FakeMon(rank=0)
    el = Elector(mon0, timeout=60.0)  # timers never fire on their own
    el.start_election()
    el.handle(None, MMonElection(op="ack", epoch=el.epoch, rank=2))
    el._election_timeout()  # a majority at expiry: victory
    assert mon0.won == (4, [0, 2])
    el.handle(None, MMonElection(op="victory", epoch=4, rank=1, quorum=[1, 2]))
    assert mon0.lost is None, "the leader followed a rival victor"
    assert el.epoch == 5 and el._electing
    assert {r for r, m in mon0.sent if m.op == "propose" and m.epoch == 5} == {1, 2}


def test_peon_hearing_two_victors_elects_again():
    mon2 = _FakeMon(rank=2)
    el = Elector(mon2, timeout=60.0)
    el.handle(None, MMonElection(op="propose", epoch=3, rank=0))
    el.handle(None, MMonElection(op="propose", epoch=3, rank=1))
    el.handle(None, MMonElection(op="victory", epoch=4, rank=0, quorum=[0, 2]))
    assert mon2.lost == (4, 0, [0, 2])
    el.handle(None, MMonElection(op="victory", epoch=4, rank=1, quorum=[1, 2]))
    assert mon2.lost == (4, 0, [0, 2]), "the peon switched to the rival victor"
    assert el.epoch == 5 and el._electing


def test_one_victory_is_followed():
    mon1 = _FakeMon(rank=1)
    el = Elector(mon1, timeout=60.0)
    el.handle(None, MMonElection(op="propose", epoch=3, rank=0))
    el.handle(None, MMonElection(op="victory", epoch=4, rank=0, quorum=[0, 1, 2]))
    el.handle(None, MMonElection(op="victory", epoch=4, rank=0, quorum=[0, 1, 2]))
    assert mon1.lost == (4, 0, [0, 1, 2])
    assert not el._electing and el.epoch == 4
