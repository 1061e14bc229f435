// The inputs and C entries of the DIB-R shading kernels (shade.cuh, built
// into epilogue.cu's library), shared with their Python entries in
// epilogue_module.cpp.  Plain C: the entries' file is compiled by the host
// compiler.

#pragma once

struct ShadeInputs {
  const int* face_idx;        // (B, H, W) int32, -1 for background
  const float* fvi;           // (B, F, 3, 2) image-plane corners, unscaled
  const float* normals;       // (B, F, 3) face normals
  const float* face_uvs;      // (F, 3, 2) corner uvs
  const float* tex;           // (TH * TW, 3) texture, channels last
  const float* sh;            // (9,) SH coefficients
  const float* soft_mask;     // (B, H, W)
  const float* target_images; // (B, H, W, 3)
  const float* target_masks;  // (B, H, W)
  int B, H, W, F, TH, TW;
  double multiplier, eps;     // rounded to float as PyTorch rounds them
};

extern "C" {
// Partial-sum rows of a launch: one per CTA, B * ceil(H * W / 256).
long long shade_blocks(int B, int H, int W);
// The loss terms (0-dim each) and each view's IoU numerator and
// denominator iou (B, 2); part: shade_blocks(B, H, W) * 3 floats.
int epilogue_shade_forward(ShadeInputs in, float* part, float* image_loss,
                           float* mask_loss, float* iou, void* stream);
// The backward for the loss terms' cotangents g_image, g_mask (0-dim, on
// the card): per pixel d_albedo (Q, 3) and the texel coords tx, ty (Q,) for
// E2, the face-row gradients rows (Q, 9) and their rows ids (Q,) for E3,
// d_soft (B, H, W); d_sh (9,); part: shade_blocks(B, H, W) * 9 floats.
int epilogue_shade_backward(ShadeInputs in, const float* iou,
                            const float* g_image, const float* g_mask,
                            float* d_albedo, float* tx, float* ty,
                            float* rows, int* ids, float* d_soft, float* part,
                            float* d_sh, void* stream);
}
