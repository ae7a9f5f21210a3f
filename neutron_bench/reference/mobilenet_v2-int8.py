"""MobileNetV2 1.0 at 224 (Sandler et al., "MobileNetV2: Inverted
Residuals and Linear Bottlenecks", arXiv:1801.04381, Table 2; the eIQ
Neutron paper's Table IV) as deployed int8 with batch norm folded into
each convolution's bias: a 3x3/2 stem of 32, the seventeen inverted
residual blocks of the table (a 1x1 expansion by t where t > 1, a 3x3
depthwise conv, a linear 1x1 projection, the input added where the
stride is 1 and the width unchanged), relu6 throughout, a 1x1 to 1280,
a global average pool and a 1000-way fully connected layer.  TensorFlow
``SAME`` padding.

Plain PyTorch through :mod:`neutron_bench.reference.qnet`; imports
nothing of the program under test.
"""

#: (expansion t, width c, blocks n, first stride s), the paper's Table 2
BLOCKS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
          (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


def forward(net, images):
    x = net.input(images)
    x = net.conv(x, 32, k=3, s=2, act="relu6")
    c_in = 32
    for t, c, n, s in BLOCKS:
        for i in range(n):
            stride = s if i == 0 else 1
            h = x
            if t != 1:
                h = net.conv(h, c_in * t, act="relu6")
            h = net.dwconv(h, k=3, s=stride, act="relu6")
            h = net.conv(h, c)
            if stride == 1 and c_in == c:
                h = net.add(x, h)
            x, c_in = h, c
    x = net.conv(x, 1280, act="relu6")
    return [net.fc(net.gap(x), 1000)]
