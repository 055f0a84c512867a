"""Work of one modulated deformable convolution forward (DCNv2), NHWC:
x (B, H, W, Cin), offset (B, Ho, Wo, 2K), mask (B, Ho, Wo, K), weight
(K * Cin, Cout), out (B, Ho, Wo, Cout).  Each byte read once and written
once; the product (2 * Cin * Cout a tap and output pixel) and the bilinear
blend (4 corners, a multiply and an add each, per tap and input channel)."""


def work(call):
    (xs, sx), (os_, so), (ms, sm), (ws, sw) = call["args"][:4]
    (outs, sout) = call["out"]
    B, H, W, Cin = xs
    _, Ho, Wo, K = ms
    Cout = outs[-1]
    pix = B * Ho * Wo
    nbytes = (sx * B * H * W * Cin + so * pix * os_[-1] + sm * pix * K
              + sw * ws[0] * ws[1] + sout * pix * Cout)
    flops = 2 * pix * K * Cin * Cout + 8 * pix * K * Cin
    return flops, nbytes, sx
