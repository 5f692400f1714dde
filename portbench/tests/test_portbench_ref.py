"""The plain reference on a sequence worked by hand, and its control."""
import numpy as np

from portbench.lib import ref

LIMIT = np.array([3, 2, 5])
RESET = np.array([100, 100, 100])


def judge(key, status, remaining, limit=None, reset=None):
    key = np.array(key)
    return ref.judge_hits(
        key, np.array(status), np.array(remaining),
        LIMIT[key] if limit is None else np.array(limit),
        RESET[key] if reset is None else np.array(reset),
        np.zeros(len(key), bool), LIMIT, RESET)


def bad(out):
    return {k: v for k, v in out.items() if k != "rows" and v}


# key 0 (limit 3) hit five times over two calls, key 1 (limit 2) once:
# key 0 answers 2, 1, 0 UNDER, then OVER twice with remaining 0
KEYS = [0, 0, 1, 0, 0, 0]
STATUS = [0, 0, 0, 0, 1, 1]
REMAINING = [2, 1, 1, 0, 0, 0]


def test_a_sequence_worked_by_hand_is_exact():
    assert bad(judge(KEYS, STATUS, REMAINING)) == {}


def test_the_order_of_two_callers_is_open():
    # the second call served first: its rows took the higher remainings
    assert bad(judge([0, 0, 0, 0, 1, 0], [0, 0, 0, 1, 0, 1],
                     [1, 2, 0, 0, 1, 0])) == {}


def test_each_break_is_counted():
    assert bad(judge(KEYS, STATUS, [2, 2, 1, 0, 0, 0])) == {
        "wrong_remaining": 1}
    assert bad(judge(KEYS, [0, 0, 0, 0, 0, 1], [2, 1, 1, 0, 0, 0])) == {
        "wrong_remaining": 1, "wrong_under_count": 1}
    assert bad(judge(KEYS, STATUS, [2, 1, 1, 0, 4, 0])) == {
        "over_with_remaining": 1}
    assert bad(judge(KEYS, STATUS, REMAINING,
                     reset=[100, 100, 100, 101, 100, 100])) == {
        "wrong_reset": 1}
    assert bad(judge(KEYS, STATUS, REMAINING,
                     limit=[3, 3, 3, 3, 3, 3])) == {"wrong_limit": 1}


def test_reads_after_the_traffic():
    hits = np.array([5, 1, 0])
    st, rem = ref.expected_reads(hits, LIMIT)
    assert st.tolist() == [1, 0, 0] and rem.tolist() == [0, 1, 5]
    # a key hit exactly to its limit read UNDER with 0 left
    st, rem = ref.expected_reads(np.array([3]), np.array([3]))
    assert st.tolist() == [0] and rem.tolist() == [0]
    key = np.array([0, 1, 2])
    ok = ref.judge_reads(key, st := np.array([1, 0, 0]), np.array([0, 1, 5]),
                         LIMIT, RESET, np.zeros(3, bool), hits, LIMIT, RESET)
    assert ok == {"reads": 3, "read_errors": 0, "read_wrong": 0}
    off = ref.judge_reads(key, st, np.array([0, 2, 5]), LIMIT, RESET,
                          np.zeros(3, bool), hits, LIMIT, RESET)
    assert off["read_wrong"] == 1


def test_the_coalescing_control_fails():
    calls = [np.array([0, 0, 1]), np.array([0, 0, 0])]
    st, rem = ref.coalesced_answers(calls, LIMIT)
    # each call debits key 0 once: 2, 2 then 1, 1, 1
    assert rem.tolist() == [2, 2, 1, 1, 1, 1]
    keys = np.concatenate(calls)
    got = judge(keys, st, rem)
    assert got["wrong_remaining"] > 0
