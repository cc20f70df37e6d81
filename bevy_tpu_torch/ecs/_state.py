"""Copy-on-write helper for the nested-dict world state: systems build a
new state dict along one path; tensors are shared, never copied."""


def set_in(d, path, value):
    out = dict(d)
    out[path[0]] = value if len(path) == 1 else set_in(d[path[0]], path[1:],
                                                        value)
    return out
