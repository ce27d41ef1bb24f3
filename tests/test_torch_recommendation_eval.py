"""``pio eval`` for the recommendation template: the port vs the JAX
package on the CPU.

The same seeded events go, in the same order, into each package's
default sqlite storage (its own ``PIO_HOME``): the two scans then share
one SQL plan and so one row order, which fixes the entity numbering.
Checks: ``read_eval``'s folds and queries equal the reference's;
``run_evaluation``'s scores are within 1e-6 of the reference's and its
EvaluationInstance is stored; and ``numeric_property`` reads a JSON-text
property column as it reads the DataMap column.
"""

import json

import numpy as np
import pytest

from predictionio_tpu.config import load_config as jax_load_config
from predictionio_tpu.controller import RuntimeContext as JaxContext
from predictionio_tpu.data.event import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import App as JaxApp
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.templates.recommendation import evaluation as jax_eval
from predictionio_tpu.templates.recommendation.engine import (
    DataSourceParams as JaxDataSourceParams,
)
from predictionio_tpu.templates.recommendation.engine import (
    RecommendationDataSource as JaxDataSource,
)
from predictionio_tpu.workflow import run_evaluation as jax_run_evaluation
from predictionio_tpu_torch.config import load_config
from predictionio_tpu_torch.controller import RuntimeContext
from predictionio_tpu_torch.data.columnar import numeric_property
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import App, Storage
from predictionio_tpu_torch.templates.recommendation import (
    DataSourceParams,
    RecommendationDataSource,
)
from predictionio_tpu_torch.templates.recommendation import (
    evaluation as port_eval,
)
from predictionio_tpu_torch.workflow.core_workflow import run_evaluation

APP = "evalapp"
SCORE_TOL = 1e-6


def _specs(seed=0, n_users=24, n_items=30, per_user=9):
    rng = np.random.default_rng(seed)
    out = []
    for u in range(n_users):
        for i in rng.choice(n_items, per_user, replace=False):
            buy = rng.random() < 0.2
            out.append(("buy" if buy else "rate", f"u{u}", f"i{i}",
                        {} if buy else {"rating": float(
                            rng.integers(1, 11) * 0.5)}))
    order = rng.permutation(len(out))
    return [out[j] for j in order]


def _fill(storage, app_cls, event_cls, map_cls, specs):
    import datetime as dt

    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    app_id = storage.get_apps().insert(app_cls(id=None, name=APP))
    events = storage.get_events()
    events.init(app_id)
    events.insert_batch([
        event_cls(event=e, entity_type="user", entity_id=u,
                  target_entity_type="item", target_entity_id=t,
                  properties=map_cls(p),
                  event_time=t0 + dt.timedelta(seconds=n))
        for n, (e, u, t, p) in enumerate(specs)], app_id)


@pytest.fixture()
def both(tmp_path):
    """(reference ctx, port ctx) over the same events on sqlite."""
    specs = _specs()
    js = JaxStorage(jax_load_config(env={"PIO_HOME": str(tmp_path / "j")}))
    ps = Storage(load_config(env={"PIO_HOME": str(tmp_path / "p")}))
    _fill(js, JaxApp, JaxEvent, JaxDataMap, specs)
    _fill(ps, App, Event, DataMap, specs)
    yield (JaxContext.create(storage=js),
           RuntimeContext.create(storage=ps, device="cpu"))
    js.close()
    ps.close()


@pytest.mark.parametrize("eval_k", [2, 3])
def test_read_eval_equals_the_reference(both, eval_k):
    jctx, pctx = both
    want = JaxDataSource(JaxDataSourceParams(
        appName=APP, evalK=eval_k, evalQueryNum=4)).read_eval(jctx)
    got = RecommendationDataSource(DataSourceParams(
        appName=APP, evalK=eval_k, evalQueryNum=4)).read_eval(pctx)
    assert len(got) == len(want) == eval_k
    for (gtd, ginfo, gqa), (wtd, winfo, wqa) in zip(got, want):
        assert ginfo is winfo is None
        for name in ("user_ids", "item_ids", "ratings"):
            np.testing.assert_array_equal(getattr(gtd, name),
                                          getattr(wtd, name))
        assert dict(gtd.user_index.items()) == dict(wtd.user_index.items())
        assert dict(gtd.item_index.items()) == dict(wtd.item_index.items())
        assert [(q.user, q.num, a) for q, a in gqa] == \
            [(q.user, q.num, a) for q, a in wqa]
        assert gqa


def test_no_folds_without_eval_k(both):
    _, pctx = both
    assert RecommendationDataSource(
        DataSourceParams(appName=APP)).read_eval(pctx) == []


def test_run_evaluation_scores_equal_the_reference(both):
    jctx, pctx = both
    kw = dict(app_name=APP, eval_k=2, ranks=(4, 6))
    jid, want = jax_run_evaluation(
        jax_eval.RecommendationEvaluation(k=5),
        jax_eval.default_params_generator(**kw), jctx)
    iid, got = run_evaluation(
        port_eval.RecommendationEvaluation(k=5),
        port_eval.default_params_generator(**kw), pctx)
    assert got.metric_header == want.metric_header == "Precision@5"
    assert got.other_metric_headers == ["Recall@5"]
    assert len(got.candidate_scores) == 2
    for (gp, gs, go), (wp, ws, wo) in zip(got.candidate_scores,
                                         want.candidate_scores):
        assert gp.to_json_dict() == wp.to_json_dict()
        assert abs(gs - ws) <= SCORE_TOL, (gs, ws)
        np.testing.assert_allclose(go, wo, rtol=0, atol=SCORE_TOL)
    assert got.best_index == want.best_index
    inst = pctx.storage.get_evaluation_instances().get(iid)
    assert inst.status == "EVALCOMPLETED"
    res = json.loads(inst.evaluator_results_json)
    assert res["metric"] == "Precision@5" and len(res["candidates"]) == 2
    assert "Precision@5" in inst.evaluator_results


def test_run_evaluation_refuses_checkpoints_and_records_failure(both):
    from predictionio_tpu_torch.controller import EngineParamsGenerator
    from predictionio_tpu_torch.workflow.core_workflow import WorkflowError

    _, pctx = both
    ev = port_eval.evaluation()
    with pytest.raises(WorkflowError, match="checkpoints"):
        run_evaluation(ev, port_eval.default_params_generator(APP), pctx,
                       checkpoint_dir="/tmp/ck")

    class Empty(EngineParamsGenerator):
        engine_params_list = []

    with pytest.raises(WorkflowError, match="no candidates"):
        run_evaluation(ev, Empty(), pctx)
    [inst] = pctx.storage.get_evaluation_instances().get_all()
    assert inst.status == "EVALFAILED"


BAGS = [{"rating": 4.5}, {"rating": True}, {"rating": None}, {},
        {"rating": "x"}, {"rating": "3.5"}, {"rating": 2}, {"other": 1.0},
        {"rating": 4.5}, {"rating": [1]}, {"rating": 1e308 * 10}]


@pytest.mark.parametrize("default", [0.0, np.nan])
def test_numeric_property_reads_json_text_as_datamaps(default):
    maps = np.empty(len(BAGS), dtype=object)
    maps[:] = [DataMap(b) for b in BAGS]
    text = np.array([json.dumps(b) for b in BAGS], dtype=object)
    want = numeric_property(maps, "rating", default)
    got = numeric_property({"properties": text}, "rating", default)
    np.testing.assert_array_equal(got, want)
    assert want[0] == 4.5 and want[5] == 3.5 and want[6] == 2.0
    assert np.isnan(want[1]) == np.isnan(default)
    # a plain list of bags of one length, as mappings and as text
    same = [DataMap({"rating": 1.0}), DataMap({"rating": "2"})]
    np.testing.assert_array_equal(
        numeric_property(same, "rating", default), [1.0, 2.0])
    np.testing.assert_array_equal(numeric_property(
        [json.dumps(dict(b)) for b in same], "rating", default), [1.0, 2.0])
