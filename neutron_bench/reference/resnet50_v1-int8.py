"""ResNet-50 v1 (He et al., "Deep Residual Learning for Image
Recognition", arXiv:1512.03385, Table 1; the eIQ Neutron paper's Table
IV) as deployed int8 with batch norm folded into each convolution's
bias: a 7x7/2 stem, a 3x3/2 max pool, bottlenecks of 3, 4, 6 and 3 at
widths 64, 128, 256 and 512 (v1: the stride on each stage's first 1x1,
a 1x1 projection on each stage's first shortcut), a global average pool
and a 1000-way fully connected layer.  TensorFlow ``SAME`` padding.

Plain PyTorch through :mod:`neutron_bench.reference.qnet`; imports
nothing of the program under test.
"""

STAGES = ((64, 3), (128, 4), (256, 6), (512, 3))


def forward(net, images):
    x = net.input(images)
    x = net.conv(x, 64, k=7, s=2, act="relu")
    x = net.maxpool(x, k=3, s=2)
    for stage, (c, n) in enumerate(STAGES):
        for i in range(n):
            s = 2 if i == 0 and stage > 0 else 1
            h = net.conv(x, c, k=1, s=s, act="relu")
            h = net.conv(h, c, k=3, act="relu")
            h = net.conv(h, 4 * c, k=1)
            short = net.conv(x, 4 * c, k=1, s=s) if i == 0 else x
            x = net.add(h, short, act="relu")
    return [net.fc(net.gap(x), 1000)]
