"""``toy_bit_ops_per_call``: the AND and popcount bit operations of one
call of the toy kind, 2 x rows x n_out x k_bits, from the cell's own shapes
(``ctx.config``, ``ctx.traffic``): a reader that reads the cell."""


def read(ctx):
    if "k_bits" not in ctx.config:
        return None
    return 2 * ctx.traffic["rows"] * ctx.config["n_out"] * ctx.config["k_bits"]
