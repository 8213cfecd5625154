"""Two-fragment plans over TPC-H for the exchange (``exec/fragments.py``):
the plans of ``chip_smoke.py``'s phase 17.

* **F1**, Q1 as two fragments: A scans lineitem, filters, projects and
  runs Q1's PARTIAL aggregation by (``l_returnflag``, ``l_linestatus``),
  then a ``partitioned_output`` by those keys into ``parts`` partitions;
  B, one task a partition, reads its exchange and runs the FINAL step.
* **F2**, Q18's inner aggregation (``sum(l_quantity)`` by ``l_orderkey``)
  the same way: A the PARTIAL step by ``l_orderkey``, B the FINAL.

``final_aggs`` writes the FINAL step's aggregates from a PARTIAL node,
for a consumer whose input is an exchange, not the PARTIAL node itself.
"""

from __future__ import annotations

from typing import List, Tuple

from velox_tpu_torch.plan.nodes import AggregationNode, AggStep


def final_aggs(partial: AggregationNode) -> Tuple[List[str], List[str]]:
    """(keys, aggregates) of the FINAL step over ``partial``'s lanes."""
    if partial.step != AggStep.PARTIAL:
        raise ValueError("final_aggs needs a PARTIAL aggregation")
    return (list(partial.keys),
            [f"{spec.fn}({name}) AS {name}"
             for name, spec in zip(partial.agg_names, partial.aggregates)])


def two_fragments(pb, producer, parts: int):
    """[A, B]: ``producer`` (a builder ending in a PARTIAL aggregation)
    shuffled by its keys into ``parts`` partitions, and one FINAL task a
    partition."""
    from velox_tpu_torch.exec.fragments import Fragment, partitioned_output

    partial = producer.node
    keys, aggs = final_aggs(partial)
    a = partitioned_output(producer, keys, parts).build()
    b = pb().exchange(partial.output_type).final_aggregation(keys, aggs)
    b = b.build()
    return [Fragment("A", a),
            Fragment("B", b, num_tasks=parts,
                     exchange_sources={b.source.id: "A"})]


def q1_fragments(pb, parts: int = 4):
    """F1: Q1's two steps as two fragments (no ORDER BY: the consumer
    tasks' rows come back in task order)."""
    from velox_tpu_torch.tpch.agg_step_plans import plan_q1

    return two_fragments(pb, plan_q1(pb, final=False), parts)


def q18_inner_fragments(pb, parts: int = 4):
    """F2: ``sum(l_quantity)`` by ``l_orderkey`` as two fragments."""
    producer = (pb().table_scan("lineitem",
                                columns=["l_orderkey", "l_quantity"])
                .partial_aggregation(["l_orderkey"],
                                     ["sum(l_quantity) AS total_qty"]))
    return two_fragments(pb, producer, parts)
