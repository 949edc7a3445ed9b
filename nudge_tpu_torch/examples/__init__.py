"""The reference's gradient examples, ported: `diff_throw` (a throw
optimised through flight, impact and sliding) and `policy_grad` (analytic
policy gradients through BoxPushEnv). Each runs on the card by default and
on the CPU with `--device cpu`."""
