// TFRecord shard decoder: framing + tf.train.Example + TensorProto in one
// native pass.
//
// The Python pipeline (data/pipeline.py) decodes Example protos one
// record at a time under the GIL; at TPU training rates the host must
// sustain tens of MB/s per chip of proto decode (reference equivalent:
// tf.data's parallel C++ readers, main_gnn.py:170-180). This decoder
// parses an entire shard per call — ctypes releases the GIL for the
// duration, so a Python thread pool over shards scales across host cores.
//
// Wire subset handled (mirrors data/proto.py):
//   record   := u64le length, u32le masked-crc(length), payload,
//               u32le masked-crc(payload)
//   Example  := field1(Features) -> repeated field1(map entry)
//               entry: field1 = key string, field2 = Feature
//               Feature: field1 = BytesList(field1 = bytes value),
//                        field3 = Int64List(field1 varint, maybe packed)
//   TensorProto := field1 varint dtype (DT_FLOAT=1),
//                  field2 TensorShapeProto (ignored; caller fixes shape),
//                  field4 tensor_content (raw LE f32)

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" uint32_t sar_crc32c(const unsigned char* data, size_t n);

namespace {

constexpr uint32_t kMaskDelta = 0xa282ead8u;

uint32_t masked_crc(const unsigned char* data, size_t n) {
  uint32_t crc = sar_crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + kMaskDelta;
}

// Varint decode; returns new position or SIZE_MAX on overrun.
size_t read_varint(const unsigned char* buf, size_t pos, size_t end,
                   uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (pos < end && shift < 64) {
    unsigned char b = buf[pos++];
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return pos;
    }
    shift += 7;
  }
  return SIZE_MAX;
}

struct Field {
  uint64_t number;
  int wire;
  const unsigned char* data;  // wire type 2: payload; else unused
  size_t len;
  uint64_t varint;  // wire type 0
};

// Iterate one submessage field at a time. Returns new pos, SIZE_MAX on
// malformed input, or `end` exactly when done.
size_t next_field(const unsigned char* buf, size_t pos, size_t end,
                  Field* f) {
  uint64_t key;
  pos = read_varint(buf, pos, end, &key);
  if (pos == SIZE_MAX) return SIZE_MAX;
  f->number = key >> 3;
  f->wire = static_cast<int>(key & 7);
  switch (f->wire) {
    case 0:
      pos = read_varint(buf, pos, end, &f->varint);
      return pos;
    case 1:
      if (pos + 8 > end) return SIZE_MAX;
      return pos + 8;
    case 2: {
      uint64_t len;
      pos = read_varint(buf, pos, end, &len);
      if (pos == SIZE_MAX || pos + len > end) return SIZE_MAX;
      f->data = buf + pos;
      f->len = static_cast<size_t>(len);
      return pos + len;
    }
    case 5:
      if (pos + 4 > end) return SIZE_MAX;
      return pos + 4;
    default:
      return SIZE_MAX;
  }
}

// Parse one serialized Example: extract the "features" BytesList value
// (a serialized TensorProto) and the "label" int64. Returns 0 on
// success.
int parse_example(const unsigned char* buf, size_t n,
                  const unsigned char** tensor, size_t* tensor_len,
                  int64_t* label, bool* has_tensor, bool* has_label) {
  *has_tensor = false;
  *has_label = false;
  size_t pos = 0;
  Field f;
  while (pos < n) {
    pos = next_field(buf, pos, n, &f);
    if (pos == SIZE_MAX) return -4;
    if (f.number != 1 || f.wire != 2) continue;  // Features
    size_t p1 = 0;
    Field e;
    while (p1 < f.len) {
      p1 = next_field(f.data, p1, f.len, &e);
      if (p1 == SIZE_MAX) return -4;
      if (e.number != 1 || e.wire != 2) continue;  // map entry
      const unsigned char* key = nullptr;
      size_t key_len = 0;
      const unsigned char* feat = nullptr;
      size_t feat_len = 0;
      size_t p2 = 0;
      Field kv;
      while (p2 < e.len) {
        p2 = next_field(e.data, p2, e.len, &kv);
        if (p2 == SIZE_MAX) return -4;
        if (kv.number == 1 && kv.wire == 2) {
          key = kv.data;
          key_len = kv.len;
        } else if (kv.number == 2 && kv.wire == 2) {
          feat = kv.data;
          feat_len = kv.len;
        }
      }
      if (key == nullptr || feat == nullptr) continue;
      bool is_features =
          key_len == 8 && std::memcmp(key, "features", 8) == 0;
      bool is_label = key_len == 5 && std::memcmp(key, "label", 5) == 0;
      if (!is_features && !is_label) continue;
      size_t p3 = 0;
      Field fv;
      while (p3 < feat_len) {
        p3 = next_field(feat, p3, feat_len, &fv);
        if (p3 == SIZE_MAX) return -4;
        if (is_features && fv.number == 1 && fv.wire == 2) {
          // BytesList -> first value
          size_t p4 = 0;
          Field bv;
          while (p4 < fv.len) {
            p4 = next_field(fv.data, p4, fv.len, &bv);
            if (p4 == SIZE_MAX) return -4;
            if (bv.number == 1 && bv.wire == 2) {
              *tensor = bv.data;
              *tensor_len = bv.len;
              *has_tensor = true;
            }
          }
        } else if (is_label && fv.number == 3 && fv.wire == 2) {
          // Int64List: varint (field 1) or packed (field 1, wire 2)
          size_t p4 = 0;
          Field iv;
          while (p4 < fv.len) {
            p4 = next_field(fv.data, p4, fv.len, &iv);
            if (p4 == SIZE_MAX) return -4;
            if (iv.number == 1 && iv.wire == 0) {
              *label = static_cast<int64_t>(iv.varint);
              *has_label = true;
            } else if (iv.number == 1 && iv.wire == 2) {
              uint64_t v;
              if (read_varint(iv.data, 0, iv.len, &v) != SIZE_MAX) {
                *label = static_cast<int64_t>(v);
                *has_label = true;
              }
            }
          }
        }
      }
    }
  }
  return (*has_tensor && *has_label) ? 0 : -4;
}

// TensorProto: verify DT_FLOAT, return tensor_content span. 0 on success.
int parse_tensorproto(const unsigned char* buf, size_t n,
                      const unsigned char** content, size_t* content_len) {
  size_t pos = 0;
  Field f;
  *content = nullptr;
  *content_len = 0;
  while (pos < n) {
    pos = next_field(buf, pos, n, &f);
    if (pos == SIZE_MAX) return -4;
    if (f.number == 1 && f.wire == 0 && f.varint != 1) return -5;  // !float
    if (f.number == 4 && f.wire == 2) {
      *content = f.data;
      *content_len = f.len;
    }
  }
  return *content != nullptr ? 0 : -4;
}

int read_file(const char* path, std::vector<unsigned char>* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  std::fseek(fp, 0, SEEK_END);
  long size = std::ftell(fp);
  if (size < 0) {
    std::fclose(fp);
    return -1;
  }
  std::fseek(fp, 0, SEEK_SET);
  out->resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(out->data(), 1, out->size(), fp) : 0;
  std::fclose(fp);
  return got == out->size() ? 0 : -1;
}

}  // namespace

// Count records in a shard by walking the framing (no crc, no decode).
// Returns count >= 0, or a negative error code.
extern "C" long sar_count_records(const char* path) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  long count = 0;
  unsigned char header[12];
  while (std::fread(header, 1, 12, fp) == 12) {
    uint64_t length;
    std::memcpy(&length, header, 8);  // little-endian hosts only (x86/TPU)
    if (std::fseek(fp, static_cast<long>(length) + 4, SEEK_CUR) != 0) {
      std::fclose(fp);
      return -2;
    }
    ++count;
  }
  std::fclose(fp);
  return count;
}

// Decode every record of one shard into caller-allocated buffers.
// out_feats has capacity max_n * feat_len floats; every sample must
// decode to exactly feat_len f32 values. Returns the number of samples,
// or negative: -1 io, -2 framing, -3 crc, -4 proto, -5 dtype/shape,
// -6 capacity.
extern "C" long sar_decode_tfrecord_file(const char* path, float* out_feats,
                                         int64_t* out_labels, long max_n,
                                         long feat_len, int check_crc) {
  std::vector<unsigned char> buf;
  if (read_file(path, &buf) != 0) return -1;
  const unsigned char* p = buf.data();
  size_t remaining = buf.size();
  long n = 0;
  const size_t sample_bytes = static_cast<size_t>(feat_len) * 4;
  while (remaining >= 12) {
    uint64_t length;
    std::memcpy(&length, p, 8);
    uint32_t lcrc;
    std::memcpy(&lcrc, p + 8, 4);
    if (remaining < 12 + length + 4) return -2;
    const unsigned char* payload = p + 12;
    uint32_t pcrc;
    std::memcpy(&pcrc, payload + length, 4);
    if (check_crc) {
      if (masked_crc(p, 8) != lcrc) return -3;
      if (masked_crc(payload, length) != pcrc) return -3;
    }
    if (n >= max_n) return -6;
    const unsigned char* tensor;
    size_t tensor_len;
    int64_t label;
    bool has_tensor, has_label;
    int rc = parse_example(payload, length, &tensor, &tensor_len, &label,
                           &has_tensor, &has_label);
    if (rc != 0) return rc;
    const unsigned char* content;
    size_t content_len;
    rc = parse_tensorproto(tensor, tensor_len, &content, &content_len);
    if (rc != 0) return rc;
    if (content_len != sample_bytes) return -5;
    std::memcpy(out_feats + static_cast<size_t>(n) * feat_len, content,
                sample_bytes);
    out_labels[n] = label;
    ++n;
    p += 12 + length + 4;
    remaining -= 12 + length + 4;
  }
  return remaining == 0 ? n : -2;
}
