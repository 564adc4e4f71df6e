"""sampler.build_s: seconds of `GibbsSampler.__init__` (the host bucket
plans and their device copies), timed by the benchmark around the call."""


def read(rec):
    return rec.spans.get("sampler.build")
