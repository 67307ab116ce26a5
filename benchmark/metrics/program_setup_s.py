"""Self seconds of the program's ``setup`` spans before the window
opened, without the traced-only FLOP probe (op ``flops_probe``)."""


def read(run):
    spans = [s for s in run.spans if s.get("span") == "setup"
             and s.get("op") != "flops_probe" and s.get("ts", 0.0) < run.w0_epoch]
    return sum(float(s["self_s"]) for s in spans) if spans else None
