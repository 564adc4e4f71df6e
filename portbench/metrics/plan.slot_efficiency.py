"""plan.slot_efficiency: rating slots over padded slots of both sides'
bucket plans (`GibbsSampler.user_plan_host`, `item_plan_host`: the
program's own counts), in %."""


def read(rec):
    if "plan.padded" not in rec.program:
        return None
    return 100.0 * rec.program["plan.nnz"] / rec.program["plan.padded"]
