"""GCDI: a query in SQL/PGQ text (``queries/<task>.sql``), run through the
program's ``sqlpgq.parse`` and ``GredoEngine.query``. Its answer is a
relation, checked against the reference's bag-semantics evaluation: the
rows mismatched (exact, limit 0), summed over the kept answers. The
control answers with duplicate rows collapsed (set semantics)."""
from gredo_bench import reference

FAMILY = "gcdi"


def load(body: dict, find) -> dict:
    text = " ".join(body["text"].split())
    return {"text": text, "spec": reference.parse(text)}


def bind(api, task):
    eng, parse, text = api.engine, api.parse, task["text"]
    return lambda: eng.query(parse(text))


def check(task: dict, kept: list, run) -> tuple:
    worst = 0
    for i, got in kept:
        want = reference.evaluate(task["spec"], run.data, run.writes_upto(i))
        worst += reference.rows_mismatched(
            reference.table_rows(got, task["spec"]["select"]), want)
    return "rows_mismatched", worst, 0


def control(task: dict, data: dict, writes: list, args, device):
    return reference.evaluate(task["spec"], data, writes, bag=False)
